"""Readers of the program's own span and counter recorder
(``stlpose_tpu_torch/utils/profiling.py``), which records while a
``torch.profiler`` session is active: in a traced run, the calls of the
device-only stretch and then those of the host-ops stretch. A reader
keeps the first ``trace.calls`` top-level calls that hold its span, those
of the device-only stretch (one an iteration of the job), and leaves out the
host-ops stretch, whose profiler records every host op. The numbers are
host times under the profiler all the same: the device-only stretch
still pays the profiler's cost for each launch and each ``span:`` range.
Each reader returns None where the recorder holds nothing to read, or
where the program has no recorder, and the metric is then left out."""

from __future__ import annotations

import statistics

from stlpose_tpu_torch.utils import profiling


def store():
    """The recorder's snapshot, or None if the program has no recorder."""
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def _calls(snap, name: str, n: int):
    """The first ``n`` top-level calls that hold span ``name``, in order,
    each with its span's host ms summed."""
    per_call = {}
    for s in sorted(snap["spans"], key=lambda s: s["call"]):
        if s["name"] == name:
            per_call[s["call"]] = (per_call.get(s["call"], 0.0) +
                                   (s["end_ns"] - s["start_ns"]) * 1e-6)
    return dict(list(per_call.items())[:n])


def span_ms(name: str):
    """A reader of span ``name``: its host ms summed within each
    top-level call of the device-only stretch, the median over them."""

    def read(trace):
        snap = store()
        if not snap:
            return None
        per_call = _calls(snap, name, trace.calls)
        return statistics.median(per_call.values()) if per_call else None

    return read


def counter_ms_per_span(counter: str, name: str):
    """A reader of counter ``counter`` (seconds, kept per top-level call)
    as ms per top-level call holding span ``name``: the median over the
    device-only stretch's calls, a call with no count reading 0."""

    def read(trace):
        snap = store()
        if not snap or "call_counters" not in snap:
            return None
        calls = _calls(snap, name, trace.calls)
        if not calls:
            return None
        per_call = dict.fromkeys(calls, 0.0)
        for n, c, v in snap["call_counters"]:
            if n == counter and c in per_call:
                per_call[c] += 1e3 * v
        return statistics.median(per_call.values())

    return read
