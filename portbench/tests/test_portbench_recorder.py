"""The per-layer metrics that read the program's span and counter recorder,
on a synthetic store: each reads its span's ms summed within a top-level
call, the median over the device-only stretch's calls (the lock wait: its
counter per batch), leaves the host-ops stretch's calls out, and reads
nothing where the recorder holds nothing or the program has none."""

from __future__ import annotations

import types

import pytest

from portbench import harness as H
from portbench import recorder

MAN = H.manifest()
READERS = [m["name"] for m in MAN["per_layer"]
           if m["source"] in ("program_span", "program_counter")]


TRACE = types.SimpleNamespace(calls=3)        # the device-only stretch's


def _store():
    """Three train steps, three pipeline batches and three serving calls
    of the device-only stretch, then two of each of the host-ops stretch
    (1 s longer a span, 0.5 s more lock wait a batch): a span ``n`` ms
    long inside call ``c`` per entry."""
    spans, ids, waits = [], iter(range(1, 1000)), []

    def call(top, children):
        cid = next(ids)
        t = 0
        for name, ms in children:
            spans.append({"id": next(ids), "name": name, "start_ns": t,
                          "end_ns": t + int(ms * 1e6), "parent": cid,
                          "call": cid})
            t += int(ms * 1e6)
        spans.append({"id": cid, "name": top, "start_ns": 0, "end_ns": t,
                      "parent": None, "call": cid})
        return cid

    for k in range(5):
        x = 1000 if k >= 3 else 0
        call("train.step", [("train.forward", 10 + k + x),
                            ("train.backward", 40 + 2 * k + x),
                            ("train.metrics", 1),
                            ("train.update", 30 - k + x)])
        batch = call("pipeline.batch", [("pipeline.load", 50 + 10 * k + x),
                                        ("pipeline.stack", 3),
                                        ("pipeline.upload", 5 + k + x),
                                        ("pipeline.finalize", 2)])
        # the second batch waited for no draw: it reads 0
        if k != 1:
            waits.append(["pipeline.aug_lock_wait_s", batch,
                          0.03 + 0.005 * k + x / 2e3])
        # two detector spans in one call sum before the median
        call("serve.call", [("serve.detect", 20 + k + x), ("serve.detect", 1),
                            ("serve.pose", 70 - k + x),
                            ("serve.fetch", 4 + k + x)])
    return {"spans": spans,
            "counters": {"pipeline.aug_lock_wait_s": sum(w[2] for w in waits)},
            "call_counters": waits}


WANT = {"step_forward_ms.train": 11.0, "step_backward_ms.train": 42.0,
        "step_update_ms.train": 29.0, "input_load_ms.train": 60.0,
        "input_upload_ms.train": 6.0, "aug_lock_wait_ms.train": 30.0,
        "input_load_ms.poses": 60.0, "input_upload_ms.poses": 6.0,
        "detect_ms.img": 22.0, "pose_ms.img": 69.0, "fetch_ms.img": 5.0}


def test_the_readers_are_the_eleven():
    assert sorted(READERS) == sorted(WANT)
    for m in MAN["per_layer"]:
        if m["name"] in WANT:
            assert m["unit"] == "ms" and m["better"] == "lower"
            assert len(m["workloads"]) == 1


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_a_synthetic_store(monkeypatch, metric):
    read = H.load_module("metrics", metric).read
    monkeypatch.setattr(recorder, "store", _store)
    assert read(TRACE) == pytest.approx(WANT[metric], rel=1e-9)
    monkeypatch.setattr(recorder, "store",
                        lambda: {"spans": [], "counters": {},
                                 "call_counters": []})
    assert read(TRACE) is None
    monkeypatch.setattr(recorder, "store", lambda: None)
    assert read(TRACE) is None


def test_a_program_without_a_recorder_reads_nothing(monkeypatch):
    from stlpose_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    assert recorder.store() is None
    assert recorder.span_ms("serve.detect")(TRACE) is None
