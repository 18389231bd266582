"""Profiling and step timing.

Port of ``stlpose_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` session (host ops, and the card's kernels when the run
is on CUDA) around a training window and writes a Chrome trace into the
directory; ``annotate`` names a span in it (``record_function``);
``StepTimer`` reports steps/s and examples/s without a device sync per
step; ``save_timing`` appends its stats to ``timing_logs.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True, device="cuda"):
    """Profile the body into ``log_dir/trace_<ns>.json`` (Chrome trace
    format, readable in Perfetto); CUDA activity is traced when
    ``device`` is a CUDA device."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span visible in the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput meter: call ``tick(n_examples)`` once per step; reads are
    amortized (no per-step device sync). The first ``warmup`` steps are
    left out.

    Stats: steps/sec, examples/sec.
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self._count = 0
        self._examples = 0
        self._t0 = None
        self._last = None

    def tick(self, n_examples: int = 0):
        now = time.perf_counter()
        self._count += 1
        if self._count == self.warmup:
            self._t0 = now
            self._examples = 0
        elif self._count > self.warmup:
            self._examples += n_examples
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return (self._count - self.warmup) / (self._last - self._t0)

    @property
    def examples_per_sec(self) -> float:
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return self._examples / (self._last - self._t0)

    def stats(self) -> dict:
        return {"steps_per_sec": round(self.steps_per_sec, 3),
                "examples_per_sec": round(self.examples_per_sec, 1)}


def save_timing(exp_path: str, name: str, stats: dict):
    """Append step-timing stats under ``name`` in the experiment's
    ``timing_logs.json``."""
    path = os.path.join(exp_path, "timing_logs.json")
    blob = {}
    if os.path.exists(path):
        with open(path) as f:
            blob = json.load(f)
    blob.setdefault(name, []).append(stats)
    with open(path, "w") as f:
        json.dump(blob, f)
