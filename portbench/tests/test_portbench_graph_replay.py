"""``graph_replay_share.train`` on a synthetic store: the share of the
device-only stretch's train steps that hold a ``train.replay`` span, the
host-ops stretch's steps left out; nothing where the recorder holds no
step or the program has no graph path."""

from __future__ import annotations

import types

import pytest

from portbench import harness as H
from portbench import recorder

READ = H.load_module("metrics", "graph_replay_share.train").read
TRACE = types.SimpleNamespace(calls=4)        # the device-only stretch's


def _store(replays):
    """A train step per entry of ``replays`` (True: it replayed), each a
    top-level call, with a pipeline batch between them."""
    spans, ids = [], iter(range(1, 1000))

    def call(top, children):
        cid = next(ids)
        for name in children:
            spans.append({"id": next(ids), "name": name, "start_ns": 0,
                          "end_ns": 1, "parent": cid, "call": cid})
        spans.append({"id": cid, "name": top, "start_ns": 0, "end_ns": 2,
                      "parent": None, "call": cid})

    for r in replays:
        call("pipeline.batch", ["pipeline.load"])
        call("train.step", ["train.replay", "train.metrics"] if r else
             ["train.forward", "train.backward", "train.metrics",
              "train.update"])
    return {"spans": spans, "counters": {}, "call_counters": []}


@pytest.mark.parametrize("replays,want", [
    ([True] * 4 + [False] * 3, 100.0),       # host-ops calls left out
    ([False, True, True, True, True], 75.0),
    ([False] * 4, 0.0)])
def test_share_of_replayed_steps(monkeypatch, replays, want):
    monkeypatch.setattr(recorder, "store", lambda: _store(replays))
    assert READ(TRACE) == pytest.approx(want, rel=1e-12)


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(recorder, "store", lambda: _store([]))
    assert READ(TRACE) is None
    monkeypatch.setattr(recorder, "store", lambda: None)
    assert READ(TRACE) is None
    from stlpose_tpu_torch.parallel import steps
    monkeypatch.setattr(recorder, "store", lambda: _store([True] * 4))
    monkeypatch.delattr(steps, "graph_route")     # a program without graphs
    assert READ(TRACE) is None
