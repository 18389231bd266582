"""A configuration, a cell and a per-layer metric added as new files plus
entries in BENCHMARK.json, with no edit to a file the harness has: the
harness finds them by name and runs the new cell."""

from __future__ import annotations

import json
import os

from portbench.tests.conftest import run_in

CODE = """
import json, sys
from portbench import run, harness as H
man = H.manifest()
_, layers = H.cell_metrics(man, "serve.frcnn_hrnet.wide_b4",
                           {"images_per_s", "latency_ms_p95", "setup_s"})
names = [m["name"] for m in layers]
read = H.load_module("metrics", "calls_per_batch.img").read
tr = H.Trace([("k", 0.0, 1.0)], [], (0.0, 2.0), 4, {}, {}, 0)
rc = run.run(["--workload", "serve.frcnn_hrnet.wide_b4", "--seed", "9",
              "--seconds", "0.5"], device="cpu")
print(json.dumps({"rc": rc, "layers": names, "value": read(tr)}))
"""


def test_new_files_make_a_new_cell(tiny_root, tmp_path):
    import shutil
    root = str(tmp_path)
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    pkg = os.path.join(root, "portbench")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(pkg) for p in fs
              if p.endswith((".py", ".json"))}
    cfg = json.load(open(os.path.join(
        pkg, "configs", "frcnn_r50fpn_hrnet_w32.f32.json")))
    cfg["detector"]["detections_per_img"] = 4
    json.dump(cfg, open(os.path.join(pkg, "configs", "frcnn_wide.f32.json"),
                        "w"))
    wl = json.load(open(os.path.join(
        pkg, "workloads", "serve.frcnn_hrnet.dense_b8.json")))
    wl["config"] = "frcnn_wide.f32"
    wl["traffic"]["batch"] = 4
    json.dump(wl, open(os.path.join(
        pkg, "workloads", "serve.frcnn_hrnet.wide_b4.json"), "w"))
    with open(os.path.join(pkg, "metrics", "calls_per_batch.img.py"),
              "w") as f:
        f.write('"""Profiled calls a device event (test)."""\n\n'
                "def read(trace):\n    return trace.calls / "
                "len(trace.events)\n")
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cell = "serve.frcnn_hrnet.wide_b4"
    man["configs"].append({"name": "frcnn_wide.f32",
                           "source": "https://example.org/wide",
                           "file": "portbench/configs/frcnn_wide.f32.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": cell, "config": "frcnn_wide.f32",
                             "traffic": "wide_b4", "chips": 1,
                             "why": "test"})
    for e in man["end_to_end"]:
        if e["name"] in ("images_per_s", "latency_ms_p95"):
            e["workloads"].append(cell)
    for m in man["per_layer"]:
        if m["moves"] == "images_per_s":
            m["workloads"].append(cell)
    man["per_layer"].append({"name": "calls_per_batch.img", "unit": "calls",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "images_per_s",
                             "workloads": [cell]})
    json.dump(man, open(os.path.join(root, "BENCHMARK.json"), "w"))
    rc, out, err = run_in(root, CODE)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["value"] == 4.0
    assert "calls_per_batch.img" in res["layers"]
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(pkg) for p in fs
             if p.endswith((".py", ".json")) and p in before}
    assert after == before
