"""The train step's CUDA graph path (stlpose_tpu_torch/parallel/steps.py)
on the CPU: the dispatch (``graph_signature``, ``graph_route``), what
drops a captured graph (``captured_state``) and PCK's divisor made on the
device, against the blocking copy of ``[H, W]`` it replaces. The graph
against the eager path on the card: ``tests/test_torch_train_graph_card.py``.
This file imports no JAX.
"""

import copy

import pytest
import torch

from stlpose_tpu_torch.ops.decode import heatmap_argmax
from stlpose_tpu_torch.parallel import steps
from stlpose_tpu_torch.train.optim import build_optimizer, set_current_lr
from stlpose_tpu_torch.train.state import PoseTrainState
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B = 4
EXP = {"training": {"learning_rate": 1e-3, "optimizer": "adam",
                    "perceptual_loss": True},
       "dataset": {"dataset_name": "styled_coco"}}


def _batch(n=B, perc=True, device="cpu"):
    b = {"image": torch.zeros(n, 256, 192, 3, device=device),
         "target": torch.zeros(n, 17, 64, 48, device=device),
         "target_weight": torch.ones(n, 17, device=device)}
    if perc:
        b["perceptual_loss"] = torch.zeros(n, device=device)
    return b


def _adam_state(device="cpu"):
    model = torch.nn.Linear(3, 2).to(device)
    return PoseTrainState(model=model,
                          optimizer=build_optimizer(EXP, model.parameters()))


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("device,group,optimizer,eager", [
    ("cpu", None, "adam", True),
    ("cuda", object(), "adam", True),        # a mesh: NCCL, global BN
    ("cuda", None, "sgd", True),             # no capturable mode
    ("cuda", None, "adam", False)])
def test_dispatch(device, group, optimizer, eager):
    params = [torch.nn.Parameter(torch.zeros(2))]
    opt = build_optimizer({"training": {"learning_rate": 1e-3,
                                        "optimizer": optimizer}}, params)
    sig = steps.graph_signature(torch.device(device), group, opt, _batch())
    graphs, warm = {}, set()
    if eager:
        assert sig is None
        assert steps.graph_route(sig, warm, graphs) == "eager"
        return
    assert steps.graph_route(sig, warm, graphs) == "warm-up"
    warm.add(sig)
    assert steps.graph_route(sig, warm, graphs) == "capture"
    graphs[sig] = object()
    assert steps.graph_route(sig, warm, graphs) == "replay"
    # another batch size, another dtype, no perceptual loss: new signatures
    for other in (_batch(B // 2), _batch(perc=False),
                  {**_batch(), "image": torch.zeros(B, 256, 192, 3,
                                                    dtype=torch.bfloat16)}):
        s = steps.graph_signature(torch.device(device), group, opt, other)
        assert s is not None and s != sig
        assert steps.graph_route(s, warm, graphs) == "warm-up"
    assert steps.graph_signature(torch.device("cuda:0"), None, opt,
                                 _batch()) == sig


def test_captured_state_sees_what_a_graph_holds():
    state = _adam_state()
    state.model(torch.ones(1, 3)).sum().backward()
    state.optimizer.step()
    held = steps.captured_state(state)
    assert steps.captured_state(state) == held
    state.optimizer.step()                     # in place: still held
    assert steps.captured_state(state) == held
    set_current_lr(state.optimizer, 1e-4)
    assert steps.captured_state(state) != held
    held = steps.captured_state(state)
    state.optimizer.load_state_dict(copy.deepcopy(
        state.optimizer.state_dict()))
    assert steps.captured_state(state) != held
    held = steps.captured_state(state)
    state.model.weight.data = state.model.weight.data.clone()
    assert steps.captured_state(state) != held


def test_captured_state_sees_batchnorm_statistics_replaced():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                torch.nn.BatchNorm1d(2))
    state = PoseTrainState(model=model, optimizer=build_optimizer(
        EXP, model.parameters()))
    held = steps.captured_state(state)
    model[1].running_mean.add_(1.0)            # in place: still held
    assert steps.captured_state(state) == held
    model[1].running_mean = model[1].running_mean.clone()
    assert steps.captured_state(state) != held


def _pck_before(pred_njhw, target_njhw, thr=0.5):
    """PCK as it was: the [H, W] divisor copied from a host list."""
    H, W = pred_njhw.shape[2], pred_njhw.shape[3]
    pred, _ = heatmap_argmax(pred_njhw)
    gt, _ = heatmap_argmax(target_njhw)
    norm = torch.tensor([H, W], dtype=torch.float32,
                        device=pred.device) / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    dist = torch.linalg.norm((pred - gt) / norm, dim=-1)
    return ((dist < thr) & valid).sum(), valid.sum()


@pytest.mark.parametrize("shape", [(8, 17, 64, 48), (5, 3, 32, 24),
                                   (2, 4, 7, 13)])
def test_pck_divisor_made_on_the_device_is_bit_identical(shape):
    g = torch.Generator().manual_seed(23)
    for _ in range(20):
        target = torch.rand(shape, generator=g)
        # predictions near the target's peaks: distances around the 0.5
        # threshold
        pred = target + 0.9 * torch.rand(shape, generator=g)
        hit, cnt = steps._pck_from_heatmaps(pred, target)
        hit0, cnt0 = _pck_before(pred, target)
        assert torch.equal(hit, hit0) and torch.equal(cnt, cnt0)
        assert hit.dtype == hit0.dtype and cnt.dtype == cnt0.dtype
