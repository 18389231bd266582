"""The port's span and counter recorder (stlpose_tpu_torch/utils/
profiling.py) and the spans the program opens: nothing recorded and no
profiler range opened while tracing is off; under a profiler, ``span:``
ranges that nest as the records' parents and top-level calls say; spans
of worker threads only as counters, each under the main thread's
top-level call; the training step's, the input
pipeline's and the fused serving program's spans; no node of them in an
exported program; ``StepTimer.stop``."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
from stlpose_tpu_torch.data.pose_dataset import PoseRecord
from stlpose_tpu_torch.engines.vase_evaluator import FusedTwoStage
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.parallel.steps import make_train_step
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils import profiling
from stlpose_tpu_torch.utils.profiling import span
import tests.torch_threads  # noqa: F401  (caps torch's threads)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def _records_by_name():
    return {s["name"]: s for s in profiling.snapshot()["spans"]}


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range was opened: {name}")

    monkeypatch.setattr(profiling, "record_function", no_range)
    with span("a"):
        with span("a.b"):
            _in_thread(lambda: span("w").__enter__().__exit__(None, None,
                                                              None))
    assert profiling.snapshot() == {"spans": [], "counters": {},
                                    "call_counters": []}


def test_spans_nest_on_the_profilers_clock(tmp_path):
    """Under ``trace`` (a CPU profiler session): the records' parents and
    calls, the ``span:`` ranges of its Chrome trace inside each other, and
    the records written beside it."""
    def item():
        with span("items"):
            time.sleep(0.001)

    with profiling.trace(str(tmp_path), device="cpu"):
        with span("call"):
            with span("call.a"):
                time.sleep(0.002)
            with span("call.b"):
                _in_thread(item)
        with span("next"):
            pass
    r = _records_by_name()
    assert r["call"]["parent"] is None and r["call"]["call"] == r["call"]["id"]
    for child in ("call.a", "call.b"):
        assert r[child]["parent"] == r[child]["call"] == r["call"]["id"]
    assert r["next"]["parent"] is None and r["next"]["call"] != \
        r["call"]["id"]
    assert r["call.a"]["end_ns"] - r["call.a"]["start_ns"] >= 2e6
    names = sorted(os.listdir(tmp_path))
    assert [n.split("_")[0] for n in names] == ["spans", "trace"]
    with open(tmp_path / names[0]) as f:
        assert json.load(f) == profiling.snapshot()
    with open(tmp_path / names[1]) as f:
        events = json.load(f)["traceEvents"]
    rng = {e["name"][5:]: (e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("name", "").startswith("span:")}
    assert set(rng) == {"call", "call.a", "call.b", "next"}
    for child in ("call.a", "call.b"):
        assert rng["call"][0] <= rng[child][0] <= rng[child][1] <= \
            rng["call"][1]
    assert rng["call"][1] <= rng["next"][0]
    (name, call, wait), = profiling.snapshot()["call_counters"]
    assert (name, call) == ("items_s", r["call"]["id"])
    assert 0.001 <= wait < 1.0


def test_worker_thread_spans_feed_counters_only():
    from torch.profiler import ProfilerActivity, profile

    def work():
        with span("pipeline.wait"):
            time.sleep(0.003)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("batch"):
            _in_thread(work)
            _in_thread(work)
        with span("batch"):
            _in_thread(work)
    snap = profiling.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["batch", "batch"]
    first, second = (s["id"] for s in snap["spans"])
    assert 0.009 <= snap["counters"]["pipeline.wait_s"] < 1.0
    per_call = {c: v for _, c, v in snap["call_counters"]}
    assert sorted(per_call) == [first, second]
    assert 0.006 <= per_call[first] and 0.003 <= per_call[second]
    ranges = {e.name for e in prof.events() if e.name.startswith("span:")}
    assert ranges == {"span:batch"}


def test_counters_from_many_threads_lose_nothing(monkeypatch):
    """16 threads (more than the cores) adding to one counter with a short
    switch interval, each span 1 ns long by a per-thread clock: every add
    is counted."""
    import sys
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0) + 1
        return local.t

    def work():
        for _ in range(500):
            with span("w"):
                pass

    monkeypatch.setattr(profiling, "_clock", clock)
    profiling.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    assert snap["spans"] == []
    assert snap["counters"]["w_s"] == pytest.approx(8000e-9, rel=1e-9)


def test_buffer_is_bounded(monkeypatch, tmp_path):
    import collections
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=3))
    profiling.enable()
    for k in range(5):
        with span(f"s{k}"):
            pass
    assert [s["name"] for s in profiling.snapshot()["spans"]] == \
        ["s2", "s3", "s4"]
    path = profiling.dump(str(tmp_path / "spans.json"))
    with open(path) as f:
        assert json.load(f) == profiling.snapshot()
    profiling.clear()
    assert profiling.snapshot()["spans"] == []


def test_pipeline_and_train_step_spans():
    """One augmented device-warp batch (two decode threads) and one train
    step of HRNET_TINY on the CPU, with ``enable()``."""
    rng = np.random.default_rng(0)
    n, S = 4, 128
    images = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    records = [PoseRecord(
        image=f"{i}.jpg", original_image=f"{i}.jpg", image_id=i,
        center=np.array([64.0, 64.0], np.float32),
        scale=np.array([0.4, 0.5], np.float32),
        joints=rng.uniform(30, 90, (17, 2)).astype(np.float32),
        joints_vis=np.ones(17, np.float32)) for i in range(n)]
    aug = {"training": {"learning_rate": 1e-3, "optimizer": "adam"},
           "dataset": {"scale_factor": 0.3, "rot_factor": 30, "flip": True,
                       "prob_half_body": 0.0}}
    pipe = PoseDataPipeline(records, n, is_train=True, exp_data=aug,
                            num_workers=2, canvas_size=S, device="cpu")
    pipe._load_one_raw = lambda rec: pipe._letterbox(images[rec.image_id],
                                                     rec)
    model = PoseHighResolutionNet(HRNET_TINY, "cpu")
    state = create_train_state(model, aug)
    step = make_train_step()
    profiling.enable()
    batch = next(iter(pipe))
    step(state, batch)
    snap = profiling.snapshot()
    r = {s["name"]: s for s in snap["spans"]}
    for top, children in (("pipeline.batch", ("pipeline.load",
                                              "pipeline.stack",
                                              "pipeline.upload",
                                              "pipeline.finalize")),
                          ("train.step", ("train.forward", "train.backward",
                                          "train.metrics", "train.update"))):
        assert r[top]["parent"] is None
        for c in children:
            assert r[c]["parent"] == r[c]["call"] == r[top]["id"], c
    assert "pipeline.aug_lock_wait" not in r
    assert snap["counters"]["pipeline.aug_lock_wait_s"] >= 0.0
    assert {(name, c) for name, c, _ in snap["call_counters"]} == \
        {("pipeline.aug_lock_wait_s", r["pipeline.batch"]["id"])}


class _Pose(torch.nn.Module):
    """A stand-in pose model for the export test: crops (K, 256, 192, 3)
    -> heatmaps (K, 64, 48, 17), one convolution (a tenth of HRNET_TINY's
    graph, which has no span)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 17, 4, stride=4)

    def forward(self, x):
        return self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _fused(pose):
    torch.manual_seed(0)
    det = FasterRCNN(FASTER_RCNN_TINY, device="cpu").eval()
    return FusedTwoStage(det, pose.eval(), bbox_thr=0.0, max_dets=2,
                         budget=4, device="cpu")


def test_fused_program_spans():
    fused = _fused(PoseHighResolutionNet(HRNET_TINY, "cpu"))
    profiling.enable()
    with torch.inference_mode():
        fused(torch.zeros((2, 128, 128, 3), dtype=torch.uint8))
    r = _records_by_name()
    detect = r["serve.detect"]
    for part in ("trunk_rpn", "proposals", "roi_heads", "detections"):
        assert r[f"detect.{part}"]["parent"] == detect["id"]
    stages = ["serve.detect", "serve.select", "serve.crop", "serve.pose",
              "serve.decode"]
    assert all(r[s]["parent"] is None for s in stages)
    starts = [r[s]["start_ns"] for s in stages]
    assert starts == sorted(starts)


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with span("outer"):
            with span("outer.inner"):
                x = x * 2.0
            return x + 1.0


def _graph(module, *args):
    with torch.no_grad():
        ep = torch.export.export(module, args, strict=False)
    return [str(n.target) for n in ep.graph.nodes]


def test_export_with_tracing_on_adds_no_nodes():
    """Spans are no-ops while ``torch.export`` traces: the same graph with
    tracing on as off, and no profiler node in the fused program's."""
    x = torch.ones(3)
    off = _graph(_Spanned(), x)
    profiling.enable()
    assert _graph(_Spanned(), x) == off
    on = _graph(_fused(_Pose()),
                torch.zeros((2, 128, 128, 3), dtype=torch.uint8))
    assert "stlpose.heatmap_peaks.default" in on
    assert not [t for t in on if "profiler" in t or "record_function" in t]
    assert profiling.snapshot()["spans"] == []


def test_step_timer_stop_ends_the_window_at_the_sync(monkeypatch):
    clock = iter([0.0, 1.0, 1.5, 2.0, 5.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()
    for _ in range(4):
        timer.tick(8)
    assert timer.stats() == {"steps_per_sec": 2.0, "examples_per_sec": 16.0}
    timer.stop()                        # the fetch returned at 5.0
    assert timer.stats() == {"steps_per_sec": 0.5, "examples_per_sec": 4.0}
