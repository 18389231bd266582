"""Each driver end to end at test sizes on the CPU (the program's kernel
wrappers run their plain versions there), judged against
``portbench/reference``: sound runs come out correct, and runs with a
fault planted under the timed path (``portbench/faults.py``) come out
not correct. The harness's look for a card is skipped (``device="cpu"``);
the rest of a run is the benchmark's own."""

from __future__ import annotations

import json

import pytest

from portbench.faults import FAULTS
from portbench.tests.conftest import run_in

CELLS = {"serve.frcnn_hrnet.dense_b8": "serve_fused",
         "train.hrnet_w32.b32": "train_step",
         "extract.hrnet_w32.flip_b32": "extract_flip"}
CASES = [(c, None) for c in CELLS] + [
    (c, f) for c in ("serve.frcnn_hrnet.dense_b8", "train.hrnet_w32.b32",
                     "extract.hrnet_w32.flip_b32")
    for f in FAULTS[CELLS[c]]]

CODE = """
import contextlib, sys
from portbench import faults, run
cm = faults.FAULTS[{driver!r}][{fault!r}]() if {fault!r} else \\
    contextlib.nullcontext()
with cm:
    sys.exit(run.run(["--workload", {cell!r}, "--seed", "5000000017",
                      "--seconds", "1"], device="cpu"))
"""


@pytest.mark.parametrize("cell,fault", CASES)
def test_cell_on_cpu(tiny_root, cell, fault):
    rc, out, err = run_in(tiny_root, CODE.format(
        cell=cell, driver=CELLS[cell], fault=fault))
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) and err.strip().splitlines()[-1].startswith(
        "check ")
    assert result["attempted"] > 0
    if fault is None:
        assert result["correct"] is True, result["checks"]
        assert result["failed"] == 0
        assert "setup_s" in result["metrics"]
    else:
        assert result["correct"] is False, result["checks"]
