"""Pose loss and perceptual-loss weighting.

Port of ``stlpose_tpu/train/loss.py``: the masked per-joint heatmap MSE,
the styled-COCO perceptual-loss weighting of the task loss, and the read
of the precomputed perceptual-loss JSON.
"""

from __future__ import annotations

import json
import os

import torch


def person_mse_loss(pred, target, target_weight=None):
    """Masked per-joint heatmap MSE: ``0.5 * mean((w*pred - w*gt)^2)``
    over batch, joints and pixels (the weight multiplies both maps, so it
    enters squared). pred/target (N, J, H, W) or (N, H, W, J), matching;
    target_weight (N, J) or None."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    if target_weight is None:
        diff = pred - target
        return 0.5 * torch.mean(diff * diff)
    n, j = target_weight.shape
    diff = pred.reshape(n, j, -1) - target.reshape(n, j, -1)
    diff = diff * target_weight[..., None]
    return 0.5 * torch.mean(diff * diff)


def _perceptual_enabled(exp_data, use_perceptual_loss):
    enabled = bool(exp_data["training"].get("perceptual_loss", False))
    if use_perceptual_loss is not None:
        enabled = enabled or use_perceptual_loss
    return (exp_data["dataset"]["dataset_name"] == "styled_coco"
            and enabled)


def apply_perceptual_loss(exp_data: dict, loss, perceptual_loss,
                          use_perceptual_loss: bool | None = None):
    """Fold the per-sample perceptual losses (N,) into the scalar task
    loss, for the styled_coco dataset with perceptual loss on: either
    ``lambda_D * loss + lambda_P * mean(perc)`` or, by default, the "add"
    scheme ``loss + loss * mean(perc)``."""
    if not _perceptual_enabled(exp_data, use_perceptual_loss):
        return loss
    training = exp_data["training"]
    mean_perc = torch.mean(torch.as_tensor(perceptual_loss,
                                           dtype=torch.float32,
                                           device=loss.device))
    lam_d = training.get("lambda_D")
    lam_p = training.get("lambda_P")
    if lam_d is not None and lam_p is not None:
        return loss * lam_d + mean_perc * lam_p
    weighting = training.get("perceptual_weight", "add")
    if weighting != "add":
        raise ValueError(f"Perceptual weighting '{weighting}' not supported")
    return loss + loss * mean_perc


def load_perceptual_loss_dict(exp_data: dict, dict_path_root: str,
                              use_perceptual_loss: bool | None = None):
    """The precomputed styled-image -> perceptual-loss mapping
    (``perceptual_loss_dict_alpha_{a}_styles_{s}.json`` under
    ``dict_path_root``), or None when the experiment does not weight by
    perceptual loss."""
    if not _perceptual_enabled(exp_data, use_perceptual_loss):
        return None
    alpha = exp_data["dataset"]["alpha"]
    style = exp_data["dataset"]["styles"]
    path = os.path.join(
        dict_path_root,
        f"perceptual_loss_dict_alpha_{alpha}_styles_{style}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Perceptual-loss dict '{path}' not found; precompute it with "
            "stlpose_tpu_torch/scripts/aux_create_offline_perceptual_loss.py")
    with open(path) as f:
        return json.load(f)
