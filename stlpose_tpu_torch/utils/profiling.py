"""Profiling: the port's span and counter recorder, and step timing.

Port of ``stlpose_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` session (host ops, and the card's kernels when the run
is on CUDA) around a training window and writes a Chrome trace into the
directory; ``StepTimer`` reports steps/s and examples/s without a device
sync per step; ``save_timing`` appends its stats to ``timing_logs.json``.

Spans and counters. ``span(name)`` is a context manager around one layer
of the program's work (``serve.detect``, ``train.backward``,
``pipeline.upload``, ...). It records only while tracing is on: while a
``torch.profiler`` session is active, or after ``enable()``. Off, a span
is a few flag checks and a return (well under 1 µs) and opens no profiler
range. While ``torch.export`` or ``torch.compile`` traces, a span is a
no-op, so exported graphs hold no node of it.

On the main thread a span records its name, its start and end
(``time.perf_counter_ns``), its parent span and the id of its top-level
call (a span opened with no span open around it: one serving call, one
train step, one pipeline batch, one extraction batch); under a profiler it
is also the range ``span:<name>``, on the profiler's clock, which is the
clock of the card's events in the same trace. Off the main thread (the
input pipeline's decode threads) a span only adds its seconds to the
counter ``<name>_s``, in total and for the main thread's latest top-level
call, so that no worker's range covers the main thread's time in a trace.
Records go to a bounded in-memory buffer: ``snapshot`` reads it, ``clear``
empties it, ``dump`` writes it as JSON; nothing is written while the
program runs. ``trace`` clears it when it starts and writes it beside the
Chrome trace (``spans_<ns>.json``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd.profiler import record_function

MAX_SPANS = 1 << 17          # records kept; the oldest go first

_profiler_enabled = torch.autograd._profiler_enabled
_is_compiling = torch.compiler.is_compiling
_get_ident = threading.get_ident
_clock = time.perf_counter_ns
_MAIN = threading.main_thread().ident

_forced = False              # enable()
_active = False              # tracing at the main thread's last span
_stack = []                  # the main thread's open spans
_call = None                 # the main thread's latest top-level call
_ids = itertools.count(1)
_spans = collections.deque(maxlen=MAX_SPANS)
_counters = {}               # (name, call) -> ns
_lock = threading.Lock()


class _Null:
    """The span when nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """A main-thread span: one record, and a profiler range under a
    profiler."""

    __slots__ = ("name", "profiled", "id", "parent", "call", "range", "t0")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.profiled = profiled

    def __enter__(self):
        global _call
        parent = _stack[-1] if _stack else None
        self.id = next(_ids)
        if parent is None:
            self.parent, self.call = None, self.id
            _call = self.id
        else:
            self.parent, self.call = parent.id, parent.call
        _stack.append(self)
        self.range = None
        if self.profiled:
            self.range = record_function(f"span:{self.name}")
            self.range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _stack.pop()
        _spans.append((self.id, self.name, self.t0, t1, self.parent,
                       self.call))
        return False


class _ThreadSpan:
    """A span off the main thread: its seconds go to ``<name>_s``, under
    the main thread's latest top-level call."""

    __slots__ = ("counter", "t0")

    def __init__(self, name: str):
        self.counter = name + "_s"

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        key = (self.counter, _call)
        dt = _clock() - self.t0
        with _lock:
            _counters[key] = _counters.get(key, 0) + dt
        return False


def span(name: str):
    """Context manager: ``name``'s span (see the module's docstring)."""
    global _active
    if _forced or _profiler_enabled():
        if _is_compiling():
            return _NULL
        if _get_ident() != _MAIN:
            return _ThreadSpan(name)
        _active = True
        return _Span(name, not _forced or _profiler_enabled())
    if _active:
        # a worker thread while the main thread traces (a profiler's
        # state is the main thread's own), or the main thread just after
        if _get_ident() != _MAIN:
            return _ThreadSpan(name)
        _active = False
    return _NULL


def enable() -> None:
    """Record spans and counters with no profiler running."""
    global _forced
    _forced = True


def disable() -> None:
    """Record only under a profiler again (the default)."""
    global _forced, _active
    _forced = _active = False


def snapshot() -> dict:
    """The records: {"spans": [{id, name, start_ns, end_ns, parent,
    call}, ...] in the order they ended, "counters": {name: seconds},
    "call_counters": [[name, call, seconds], ...]}."""
    keys = ("id", "name", "start_ns", "end_ns", "parent", "call")
    with _lock:
        counters = list(_counters.items())
    totals = {}
    for (name, _), ns in counters:
        totals[name] = totals.get(name, 0) + ns
    return {"spans": [dict(zip(keys, r)) for r in list(_spans)],
            "counters": {n: ns * 1e-9 for n, ns in totals.items()},
            "call_counters": [[n, c, ns * 1e-9]
                              for (n, c), ns in counters]}


def clear() -> None:
    """Drop every record and counter."""
    _spans.clear()
    with _lock:
        _counters.clear()


def dump(path: str) -> str:
    """Write ``snapshot()`` to ``path`` as JSON; returns the path."""
    with open(path, "w") as f:
        json.dump(snapshot(), f)
    return path


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True, device="cuda"):
    """Profile the body into ``log_dir/trace_<ns>.json`` (Chrome trace
    format, readable in Perfetto; the spans are its ``span:`` ranges) and
    its span records into ``log_dir/spans_<ns>.json``; CUDA activity is
    traced when ``device`` is a CUDA device."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    clear()
    with profile(activities=activities) as prof:
        yield
    stamp = time.time_ns()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    dump(os.path.join(log_dir, f"spans_{stamp}.json"))


class StepTimer:
    """Throughput meter: call ``tick(n_examples)`` once per step; reads are
    amortized (no per-step device sync). The first ``warmup`` steps are
    left out. A tick marks when a step was enqueued; ``stop()``, called
    after the device has synchronised (a fetch of the epoch's metrics),
    moves the window's end there, so the rates count the device's work.

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

    def stop(self):
        """End the window now (no step counted)."""
        if self._last is not None:
            self._last = time.perf_counter()

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
