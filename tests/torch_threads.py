"""Caps the intra-op threads of torch in the port's CPU tests.

The tier-1 suite runs in 6 pytest-xdist workers on one machine, and each
worker's torch would start a thread per core: the workers' convolutions
then crowd out the suite's longest file, tests/test_pallas_roi.py
(interpret-mode Pallas, mostly one thread), which sets the suite's wall
time. Every tests/test_torch_*.py that runs torch imports this module;
each worker imports every test file while collecting, so the cap holds in
all of them from the first test on.
"""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
