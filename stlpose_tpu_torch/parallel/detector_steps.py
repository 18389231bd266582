"""Detector train step and predict function, on one device or
data-parallel over a mesh.

Port of ``stlpose_tpu/parallel/detector_steps.py``
(``make_detector_train_step``, ``make_detector_predict``). One train step
is ``FasterRCNN.loss_fn`` (train-mode trunk, RPN loss, train-budget
proposals on K5, RoI sampling, RoIAlign on K3, box-head loss), the
optional perceptual weighting, autograd's backward (RoIAlign's on K3b)
and the optimizer update, with the reference's non-finite guard: when the
loss is not finite the gradients are zeroed and the optimizer still steps
(Adam's moments decay, its count advances), but the parameters keep their
values. The guard runs on the device with no host sync: the parameters
are copied before the update and put back where the loss was not finite.

With a ``mesh`` of W ranks each rank steps on its rows of the global
batch: the trunk's BatchNorm statistics are the global batch's; the
sampling draws the global batch's uniforms from the one seeded generator
on every rank and keeps this rank's rows, so it samples what the
one-process step samples; the gradients, the total and the loss terms
(each the mean over the rank's images) are summed in one flattened
all-reduce and divided by W, which makes every loss the global batch's
mean; and the guard tests that global loss, so every rank skips or steps
together. ``make_detector_predict`` runs each rank's rows locally (the
reference's ``shard_map`` form).
"""

from __future__ import annotations

from typing import Callable

import torch

from stlpose_tpu_torch.parallel.mesh import mesh_group, mesh_rank, mesh_size
from stlpose_tpu_torch.parallel.steps import (global_mean, reduce_gradients,
                                              use_global_batchnorm)
from stlpose_tpu_torch.train.loss import apply_perceptual_loss
from stlpose_tpu_torch.train.state import PoseTrainState


def make_detector_train_step(perceptual_cfg: dict | None = None,
                             mesh=None) -> Callable:
    """step(state, batch, generator=None, uniforms=None) -> metrics: one
    update of ``state`` (a detector and its optimizer) in place.

    batch: {image (N, S, S, 3), boxes (N, K, 4), labels (N, K), box_mask
    (N, K), perceptual_loss (N,)} on the model's device (with a ``mesh``,
    this rank's rows); ``generator`` and ``uniforms`` go to ``loss_fn``'s
    sampling. Metrics (device tensors, global on every rank): "loss"
    (before the update), "finite" (1.0 or 0.0) and the loss terms."""
    group, world = mesh_group(mesh), mesh_size(mesh)

    def step(state: PoseTrainState, batch, generator=None, uniforms=None):
        model = state.model
        rows = None
        if group is not None:
            use_global_batchnorm(model, group)
            n = batch["image"].shape[0]
            rows = (mesh_rank(mesh) * n, world * n)
        total, loss_dict = model.loss_fn(batch, generator, uniforms,
                                         rows=rows)
        if perceptual_cfg is not None:
            perc = batch.get("perceptual_loss", 0.0)
            if group is not None:
                perc = global_mean(perc, group, world).to(total.device)
            total = apply_perceptual_loss(perceptual_cfg, total, perc)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for p in model.parameters() if p.requires_grad]
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in loss_dict.items()}}
        if group is not None:
            sums = reduce_gradients(params, list(metrics.values()), group,
                                    world)
            metrics = {k: (t / world).to(v.dtype)
                       for (k, v), t in zip(metrics.items(), sums)}
        finite = torch.isfinite(metrics["loss"])
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
        return {"loss": metrics.pop("loss"),
                "finite": finite.to(torch.float32), **metrics}

    return step


def make_detector_predict(detector) -> Callable:
    """predict(images) -> padded {boxes, scores, labels, valid}: the
    detector's eval-mode ``predict`` (images (N, S, S, 3) in [0, 1] on its
    device; on a mesh, each rank's rows, predicted with no collective: the
    reference's ``shard_map`` form needs nothing more). Closes over the
    detector, which holds its weights, where the reference's takes the
    train state first."""

    def predict(images):
        return detector.predict(images)

    return predict
