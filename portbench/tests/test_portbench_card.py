"""On the card (skipped without one): a cell through the benchmark's own
command, and each cell's control (the reference computed with TF32 in
the program's place) coming out not correct at the cell's own size."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness as H
from portbench.tests.tiny import REPO

CELLS = [w["name"] for w in H.manifest()["workloads"]]


@pytest.mark.card
def test_command_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "5000000099", "--seconds", "3",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, tmp_path, cell):
    out = tmp_path / "readings.jsonl"
    p = subprocess.run([sys.executable, "-m", "portbench.readings",
                        "--workload", cell, "--seconds", "2", "--control",
                        "5000000101,5000000102,5000000103", "--out",
                        str(out)], cwd=REPO, capture_output=True, text=True,
                       timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    limits = H.load_cell(cell)["workload"]["limits"]
    for line in out.read_text().splitlines():
        numbers = json.loads(line)["numbers"]
        assert not H.verdict(numbers, limits)[0], numbers
