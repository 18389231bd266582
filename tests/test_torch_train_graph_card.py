"""The train step's CUDA graph path against its eager path, on the card
(marker ``card``; ``python -m pytest tests/test_torch_train_graph_card.py
-m card``; skips without a CUDA device): one seeded HRNET_TINY state,
B = 4, cuDNN deterministic and TF32 off, both paths with Adam made
capturable. Losses, PCK counts, parameters, BatchNorm statistics and
Adam's moments agree to 1e-6 of each tensor's largest magnitude (the same
kernels on the same inputs: the graph only launches them otherwise), over
four steps, a learning-rate change, a reloaded optimizer state, half-size
batches and a bf16-compute model; the spans say which steps captured and
which replayed. This file imports no JAX.
"""

import copy

import pytest
import torch

from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.parallel import steps
from stlpose_tpu_torch.train.optim import set_current_lr
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils import profiling
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B = 4
EXP = {"training": {"learning_rate": 1e-3, "optimizer": "adam",
                    "perceptual_loss": True},
       "dataset": {"dataset_name": "styled_coco"}}
CUDA = torch.device("cuda")
REL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph path runs only on the card")
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _card_batches(n=4):
    g = torch.Generator().manual_seed(7)
    out = []
    for _ in range(n):
        out.append({
            "image": torch.randn(B, 256, 192, 3, generator=g).to(CUDA),
            "target": torch.rand(B, 17, 64, 48, generator=g).to(CUDA),
            "target_weight": (torch.rand(B, 17, generator=g) > 0.2).float()
            .to(CUDA),
            "perceptual_loss": torch.rand(B, generator=g).to(CUDA)})
    return out


def _seeded(dtype):
    torch.manual_seed(5)
    return PoseHighResolutionNet(HRNET_TINY, "cpu", dtype,
                                 param_dtype=torch.float32).state_dict()


def _train(plan, graph: bool, dtype=torch.float32):
    """Run ``plan`` from the seeded state: an int k steps on batch k, ("half",
    k) on its first B / 2 rows, ("lr", x) sets the learning rate, "save"
    and "load" keep and restore a copy of the optimizer's state. Returns
    the losses, PCK counts, metric dicts, final state and the spans of
    each step."""
    model = PoseHighResolutionNet(HRNET_TINY, CUDA, dtype,
                                  param_dtype=torch.float32)
    model.load_state_dict(_seeded(dtype))
    state = create_train_state(model, EXP)
    steps.make_capturable(state.optimizer)
    step = steps.make_train_step(perceptual_cfg=EXP)
    batches = _card_batches()
    metrics, saved = [], None
    profiling.clear()
    profiling.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            if not graph:
                mp.setattr(steps, "graph_signature", lambda *a: None)
            for item in plan:
                if isinstance(item, int):
                    metrics.append(step(state, batches[item]))
                elif item == "save":
                    saved = copy.deepcopy(state.optimizer.state_dict())
                elif item == "load":
                    state.optimizer.load_state_dict(saved)
                elif item[0] == "lr":
                    set_current_lr(state.optimizer, item[1])
                else:                                  # ("half", k)
                    b = batches[item[1]]
                    metrics.append(step(state, {k: v[:B // 2]
                                                for k, v in b.items()}))
        torch.cuda.synchronize()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.clear()
    calls = {}
    for s in snap["spans"]:
        calls.setdefault(s["call"], set()).add(s["name"])
    spans = [calls[c] for c in sorted(calls)]
    opt = state.optimizer
    moments = [opt.state[p][k].clone() for p in model.parameters()
               for k in ("exp_avg", "exp_avg_sq")]
    return {"loss": [float(m["loss"]) for m in metrics],
            "pck": [(int(m["pck_hit"]), int(m["pck_cnt"])) for m in metrics],
            "metrics": metrics, "spans": spans, "step": state.step,
            "weights": {k: v.clone() for k, v in model.state_dict().items()},
            "moments": moments}


def _close(got, want):
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) <= REL * scale


PLANS = {
    "four_steps": ([0, 1, 2, 3], 1),
    "learning_rate": ([0, 1, ("lr", 1e-4), 2, 3], 2),
    "load_state_dict": ([0, "save", 1, 2, "load", 3, 0], 2),
    "half_batch": ([0, 1, ("half", 2), ("half", 3), ("half", 0), 1, 2], 2),
    "bf16": ([0, 1, 2, 3], 1)}


@pytest.mark.card
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_graph_path_matches_eager(card, plan):
    items, captures = PLANS[plan]
    dtype = torch.bfloat16 if plan == "bf16" else torch.float32
    eager = _train(items, graph=False, dtype=dtype)
    got = _train(items, graph=True, dtype=dtype)
    n = len(got["loss"])
    for a, b in zip(got["loss"], eager["loss"]):
        assert abs(a - b) <= REL * abs(b)
    assert got["pck"] == eager["pck"]
    assert got["step"] == eager["step"] == n
    _close(list(got["weights"].values()), list(eager["weights"].values()))
    _close(got["moments"], eager["moments"])
    # the eager path never captures; the graph path replays every step
    # but the first of each signature (again after a new learning rate or
    # a reloaded optimizer state)
    assert all("train.replay" not in s for s in eager["spans"])
    assert sum("train.capture" in s for s in got["spans"]) == captures
    assert sum("train.replay" in s for s in got["spans"]) == n - captures
    assert "train.replay" in got["spans"][1]
    assert all({"train.step", "train.metrics"} <= s for s in got["spans"])
    # each step's metrics are its own tensors, not the graph's buffers
    ptrs = {m["loss"].data_ptr() for m in got["metrics"]}
    assert len(ptrs) == n
    assert [float(m["loss"]) for m in got["metrics"]] == got["loss"]
