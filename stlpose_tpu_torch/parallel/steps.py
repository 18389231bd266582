"""Pose train, eval and inference steps on one device, and the device-side
metric accumulator.

Port of ``stlpose_tpu/parallel/steps.py`` (``make_train_step``,
``make_eval_step``, ``make_infer_fn``, ``make_eval_decode_step``,
``_pck_from_heatmaps``, ``MetricAccumulator``) for a single device: no
mesh. One train step is HRNet's train-mode forward, the masked MSE
(optionally weighted by the perceptual loss), autograd's backward, the
optimizer update and the PCK metric, whose two peak searches run on K1.
The eval and inference functions run under ``torch.no_grad()``; with
flip-TTA the mirrored crops (``torch.flip`` of the width axis) go into the
same batch for one forward of 2N crops, and the two halves are combined
in the model's (N, H, W, J) view, as the reference does. That view lies
on NCHW memory and the combine's elementwise ops keep that layout, so the
(N, J, H, W) view that the loss, PCK and decode read is contiguous maps:
K1's bulk kernel. A step switches the model's mode only when it is not
already in the one it needs (eval for the eval functions, train for the
train step): ``model.eval()`` or ``model.train()`` walks HRNet-W32's
~1,000 modules, some milliseconds of host time before the first launch of
every call.
Nothing is fetched to the host: the metrics stay device tensors.

The inference functions close over the model, which holds its weights:
``make_infer_fn`` and ``make_eval_decode_step`` return functions of the
batch alone, where the reference's take the train state first.
"""

from __future__ import annotations

from typing import Callable

import torch

from stlpose_tpu_torch.ops.decode import decode_heatmaps, heatmap_argmax
from stlpose_tpu_torch.ops.flip import average_flip_tta_nhwc
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
        if not model.training:
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


def _forward_heatmaps(model, images, flip_tta: bool):
    """Eval-mode forward -> (N, J, H, W) heatmaps; with ``flip_tta`` one
    forward of the crops and their mirror images, combined by
    ``average_flip_tta_nhwc``."""
    if model.training:
        model.eval()
    if not flip_tta:
        return _nhwc_to_njhw(model(images))
    n = images.shape[0]
    out = model(torch.cat([images, torch.flip(images, dims=[2])], dim=0))
    return _nhwc_to_njhw(average_flip_tta_nhwc(out[:n], out[n:]))


def _eval_metrics(pred_njhw, batch):
    loss = person_mse_loss(pred_njhw, batch["target"], batch["target_weight"])
    hit, cnt = _pck_from_heatmaps(pred_njhw, batch["target"])
    return {"loss": loss, "pck_hit": hit, "pck_cnt": cnt}


def make_eval_step(flip_tta: bool = False) -> Callable:
    """step(state, batch) -> (heatmaps (N, J, H, W), metrics): eval-mode
    forward (optionally flip-TTA), loss and PCK."""

    def step(state: PoseTrainState, batch):
        with torch.no_grad():
            pred = _forward_heatmaps(state.model, batch["image"], flip_tta)
            return pred, _eval_metrics(pred, batch)

    return step


def make_infer_fn(model, flip_tta: bool = True,
                  decode: bool = True) -> Callable:
    """Crops -> heatmaps -> keypoints in source-image pixels.

    Returns fn(images, centers, scales) -> (preds (N, J, 3) [x, y,
    maxval], heatmaps (N, J, H, W)) when ``decode``, else fn(images) ->
    heatmaps. Runs where ``model`` lives."""

    def infer_hm(images):
        with torch.no_grad():
            return _forward_heatmaps(model, images, flip_tta)

    if not decode:
        return infer_hm

    def infer(images, centers, scales):
        with torch.no_grad():
            hm = _forward_heatmaps(model, images, flip_tta)
            preds, maxvals, _ = decode_heatmaps(hm, centers, scales)
            return torch.cat([preds, maxvals[..., None]], dim=-1), hm

    return infer


def make_eval_decode_step(model, flip_tta: bool = True) -> Callable:
    """The evaluator's whole per-batch device work: flip-TTA forward, loss,
    PCK and decoded keypoints from one forward.

    Returns fn(batch) -> (preds (N, J, 3) [x, y, maxval] in source-image
    pixels, metrics); ``batch`` holds image, target, target_weight, center
    and scale as tensors on the model's device."""

    def step(batch):
        with torch.no_grad():
            hm = _forward_heatmaps(model, batch["image"], flip_tta)
            metrics = _eval_metrics(hm, batch)
            preds, maxvals, _ = decode_heatmaps(hm, batch["center"],
                                                batch["scale"])
            return torch.cat([preds, maxvals[..., None]], dim=-1), metrics

    return step
