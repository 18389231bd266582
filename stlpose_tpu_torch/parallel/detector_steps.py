"""Detector train step and predict function on one device.

Port of ``stlpose_tpu/parallel/detector_steps.py``
(``make_detector_train_step``, ``make_detector_predict``) for a single
device: no mesh. One train step is ``FasterRCNN.loss_fn`` (train-mode
trunk, RPN loss, train-budget proposals on K5, RoI sampling, RoIAlign on
K3, box-head loss), the optional perceptual weighting, autograd's backward
(RoIAlign's on K3b) and the optimizer update, with the reference's
non-finite guard: when the loss is not finite the gradients are zeroed
and the optimizer still steps (Adam's moments decay, its count advances),
but the parameters keep their values. The guard runs on the device with
no host sync: the parameters are copied before the update and put back
where the loss was not finite.
"""

from __future__ import annotations

from typing import Callable

import torch

from stlpose_tpu_torch.train.loss import apply_perceptual_loss
from stlpose_tpu_torch.train.state import PoseTrainState


def make_detector_train_step(perceptual_cfg: dict | None = None
                             ) -> Callable:
    """step(state, batch, generator=None, uniforms=None) -> metrics: one
    update of ``state`` (a detector and its optimizer) in place.

    batch: {image (N, S, S, 3), boxes (N, K, 4), labels (N, K), box_mask
    (N, K), perceptual_loss (N,)} on the model's device; ``generator`` and
    ``uniforms`` go to ``loss_fn``'s sampling. Metrics (device tensors):
    "loss" (before the update), "finite" (1.0 or 0.0) and the four loss
    terms."""

    def step(state: PoseTrainState, batch, generator=None, uniforms=None):
        model = state.model
        total, loss_dict = model.loss_fn(batch, generator, uniforms)
        if perceptual_cfg is not None:
            total = apply_perceptual_loss(perceptual_cfg, total,
                                          batch.get("perceptual_loss", 0.0))
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        finite = torch.isfinite(total.detach())
        params = [p for p in model.parameters() if p.requires_grad]
        with torch.no_grad():
            for p in params:
                if p.grad is None:      # unreached: a zero gradient
                    p.grad = torch.zeros_like(p)
                p.grad.masked_fill_(~finite, 0.0)
            before = [p.detach().clone() for p in params]
        state.optimizer.step()
        with torch.no_grad():
            for p, old in zip(params, before):
                p.copy_(torch.where(finite, p, old))
        state.step += 1
        return {"loss": total.detach(), "finite": finite.to(torch.float32),
                **{k: v.detach() for k, v in loss_dict.items()}}

    return step


def make_detector_predict(detector) -> Callable:
    """predict(images) -> padded {boxes, scores, labels, valid}: the
    detector's eval-mode ``predict`` (images (N, S, S, 3) in [0, 1] on its
    device). Closes over the detector, which holds its weights, where the
    reference's takes the train state first."""

    def predict(images):
        return detector.predict(images)

    return predict
