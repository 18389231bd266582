#!/usr/bin/env python
"""Create an experiment directory and its parameters JSON.

    python stlpose_tpu_torch/scripts/01_create_experiment.py -d NAME [--batch_size 32 ...]

Counterpart of ``scripts/01_create_experiment.py``: the arguments given
are merged over the defaults into
``<STLPOSE_EXPERIMENTS_PATH>/NAME/experiment_<timestamp>/`` with
``models/``, ``plots/``, ``experiment_parameters.json`` and
``logs.txt``; the last line printed is the experiment's path.
"""

import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.utils.arguments import \
    process_create_experiment_arguments  # noqa: E402
from stlpose_tpu_torch.utils.experiment import create_experiment  # noqa: E402
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None) -> str:
    args = process_create_experiment_arguments(argv)
    overrides = {k: v for k, v in vars(args).items() if k != "exp_directory"}
    exp_path = create_experiment(args.exp_directory, overrides)
    Logger(exp_path)
    print_(f"Created experiment at {exp_path}", type="new_exp")
    print(exp_path)
    return exp_path


if __name__ == "__main__":
    main()
