"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration and metric found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import harness as H

MAN = H.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(MAN) == KEYS["top"]
    assert os.path.getsize(os.path.join(H.ROOT, "BENCHMARK.json")) <= 65536
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert set(e) - {"workloads"} <= KEYS[group], e["name"]
            assert KEYS[group] <= set(e), e["name"]


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])


def test_paths_and_files():
    assert MAN["paths"] == ["portbench"]
    for c in MAN["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(H.ROOT, c["file"]))
        assert c["source"].startswith("https://")
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_found_by_name(cell):
    c = H.load_cell(cell)
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert c["workload"]["config"] == entry["config"]
    assert callable(c["driver"].setup)
    assert set(c["workload"]["limits"]) and all(
        v >= 0 for v in c["workload"]["limits"].values())
    assert c["config"]["tf32"] is False and c["config"]["dtype"] == "float32"


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_found_by_name_and_moves(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    reader = H.load_module("metrics", metric).read
    assert callable(reader)
    if hasattr(reader, "ROOFLINE"):
        rl = H.load_module("roofline", reader.ROOFLINE)
        assert rl.KERNELS and callable(rl.work) and callable(rl.capture)
        assert metric.split(".")[0].endswith("_roofline") and m["unit"] == "%"
    if "mfu" in metric:
        assert m["unit"] == "%"
    moves = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for cell in cells:
        assert cell in moves.get("workloads", [cell])


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [e["name"] for e in MAN["end_to_end"]
               if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in MAN["per_layer"])
        assert any("mfu" in m["name"] and w["name"] in m["workloads"]
                   for m in MAN["per_layer"])


def test_bounds_and_run_length():
    for e in MAN["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert next(e for e in MAN["end_to_end"]
                if e["name"] == "setup_s")["bound"] <= 0.25
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_state_their_cuts():
    for c in MAN["configs"]:
        cfg = json.load(open(os.path.join(H.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] == []
        assert "assumed" in cfg
