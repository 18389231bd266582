"""Pose train and eval steps on one device, and the device-side metric
accumulator.

Port of ``stlpose_tpu/parallel/steps.py`` (``make_train_step``,
``make_eval_step`` without flip-TTA, ``_pck_from_heatmaps``,
``MetricAccumulator``) for a single device: no mesh. One train step is
HRNet's train-mode forward, the masked MSE (optionally weighted by the
perceptual loss), autograd's backward, the optimizer update and the PCK
metric, whose two peak searches run on K1. Nothing is fetched to the
host: the metrics stay device tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from stlpose_tpu_torch.ops.decode import heatmap_argmax
from stlpose_tpu_torch.train.loss import (apply_perceptual_loss,
                                          person_mse_loss)
from stlpose_tpu_torch.train.state import PoseTrainState


def _nhwc_to_njhw(hm):
    """(N, H, W, J) model output -> (N, J, H, W) view."""
    return hm.permute(0, 3, 1, 2)


def _pck_from_heatmaps(pred_njhw, target_njhw, thr=0.5):
    """PCK hits and count with the reference's normalisation (the (x, y)
    offset divided by (H, W) / 10), over joints whose target peak lies
    past (1, 1)."""
    H, W = pred_njhw.shape[2], pred_njhw.shape[3]
    pred, _ = heatmap_argmax(pred_njhw)
    gt, _ = heatmap_argmax(target_njhw)
    norm = torch.tensor([H, W], dtype=torch.float32,
                        device=pred.device) / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    dist = torch.linalg.norm((pred - gt) / norm, dim=-1)
    return ((dist < thr) & valid).sum(), valid.sum()


class MetricAccumulator:
    """Running sums of step metrics on the device: ``update`` only
    enqueues adds (no host sync), ``fetch`` brings the sums to the host
    once. For keys in ``finite_only`` a non-finite value is skipped and the
    finite steps are counted. ``fetch`` returns ``{"n": steps,
    "<k>_sum", "<k>_n", "<k>_mean"}``."""

    def __init__(self, finite_only: tuple = ()):
        self._sums = None
        self._finite_only = tuple(finite_only)

    def update(self, metrics: dict) -> None:
        vals = {k: torch.as_tensor(v).to(torch.float32)
                for k, v in metrics.items()}
        if self._sums is None:
            zero = torch.zeros((), dtype=torch.float32,
                               device=next(iter(vals.values())).device)
            self._sums = {"_n": zero.clone()}
            for k in vals:
                self._sums[k] = zero.clone()
                if k in self._finite_only:
                    self._sums[f"_{k}_finite"] = zero.clone()
        self._sums["_n"] += 1.0
        for k, v in vals.items():
            if k in self._finite_only:
                ok = torch.isfinite(v)
                self._sums[k] += torch.where(ok, v, 0.0)
                self._sums[f"_{k}_finite"] += ok.to(torch.float32)
            else:
                self._sums[k] += v

    @property
    def empty(self) -> bool:
        return self._sums is None

    def fetch(self) -> dict:
        """One host transfer of the running sums."""
        if self._sums is None:
            return {"n": 0.0}
        keys = list(self._sums)
        host = dict(zip(keys, torch.stack([self._sums[k] for k in keys])
                        .tolist()))
        n = host["_n"]
        out = {"n": n}
        for k, v in host.items():
            if k.startswith("_"):
                continue
            denom = host.get(f"_{k}_finite", n)
            out[f"{k}_sum"] = v
            out[f"{k}_n"] = denom
            out[f"{k}_mean"] = v / denom if denom else 0.0
        return out


def make_train_step(perceptual_cfg: dict | None = None) -> Callable:
    """step(state, batch) -> metrics: one update of ``state`` in place.

    ``batch`` holds "image" (N, 256, 192, 3), "target" (N, J, 64, 48),
    "target_weight" (N, J) and, with ``perceptual_cfg`` (the experiment
    dict), "perceptual_loss" (N,). Metrics: "loss" (before the update),
    "pck_hit" and "pck_cnt" of the forward's heatmaps."""

    def step(state: PoseTrainState, batch):
        model = state.model
        model.train()
        pred = _nhwc_to_njhw(model(batch["image"]))
        loss = person_mse_loss(pred, batch["target"], batch["target_weight"])
        if perceptual_cfg is not None:
            loss = apply_perceptual_loss(perceptual_cfg, loss,
                                         batch.get("perceptual_loss", 0.0))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        hit, cnt = _pck_from_heatmaps(pred.detach(), batch["target"])
        return {"loss": loss.detach(), "pck_hit": hit, "pck_cnt": cnt}

    return step


def make_eval_step() -> Callable:
    """step(state, batch) -> (heatmaps (N, J, H, W), metrics): eval-mode
    forward, loss and PCK; no flip-TTA."""

    def step(state: PoseTrainState, batch):
        model = state.model
        model.eval()
        with torch.no_grad():
            pred = _nhwc_to_njhw(model(batch["image"]))
            loss = person_mse_loss(pred, batch["target"],
                                   batch["target_weight"])
            hit, cnt = _pck_from_heatmaps(pred, batch["target"])
        return pred, {"loss": loss, "pck_hit": hit, "pck_cnt": cnt}

    return step
