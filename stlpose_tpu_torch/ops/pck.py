"""PCK accuracy from heatmaps (the train-time metric).

Port of ``stlpose_tpu/ops/pck.py``, with the reference's quirks: the
normalisation vector is [H, W] / 10 applied to (x, y) offsets, and joints
whose target peak lies at or before (1, 1) are left out. ``pck_accuracy``
takes its peaks from K1 (``ops/decode.py::heatmap_argmax``);
``pck_accuracy_np`` is the host numpy oracle with the same semantics.
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch.ops.decode import heatmap_argmax


def pck_accuracy(output, target, thr: float = 0.5):
    """Mean PCK@thr over joints with valid targets.

    output, target: (N, J, H, W). Returns (avg_acc, per_joint (J,) with -1
    where a joint has no valid sample, cnt of joints with one), as device
    tensors."""
    H, W = output.shape[2], output.shape[3]
    pred, _ = heatmap_argmax(output)
    gt, _ = heatmap_argmax(target)
    norm = torch.tensor([H, W], dtype=torch.float32,
                        device=pred.device) / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    dist = torch.linalg.norm((pred - gt) / norm, dim=-1)
    hit = (dist < thr) & valid
    n_valid = valid.sum(dim=0)
    per_joint = torch.where(n_valid > 0,
                            hit.sum(dim=0) / n_valid.clamp_min(1), -1.0)
    joint_ok = per_joint >= 0
    cnt = joint_ok.sum()
    avg = torch.where(cnt > 0, torch.where(joint_ok, per_joint, 0.0).sum()
                      / cnt.clamp_min(1), 0.0)
    return avg, per_joint, cnt


def pck_accuracy_np(output, target, thr: float = 0.5):
    """Host-numpy oracle of :func:`pck_accuracy`."""
    output = np.asarray(output)
    target = np.asarray(target)
    H, W = output.shape[2], output.shape[3]

    def argmax_np(hm):
        N, J = hm.shape[0], hm.shape[1]
        flat = hm.reshape(N, J, -1)
        idx = flat.argmax(-1)
        mx = flat.max(-1)
        x = (idx % W).astype(np.float32)
        y = np.floor(idx / W).astype(np.float32)
        coords = np.stack([x, y], -1)
        coords *= (mx > 0)[..., None]
        return coords

    pred, gt = argmax_np(output), argmax_np(target)
    norm = np.array([H, W], np.float32) / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    dist = np.linalg.norm((pred - gt) / norm, axis=-1)
    hit = (dist < thr) & valid
    n_valid = valid.sum(0)
    per_joint = np.where(n_valid > 0, hit.sum(0) / np.maximum(n_valid, 1),
                         -1.0)
    ok = per_joint >= 0
    cnt = int(ok.sum())
    avg = float(per_joint[ok].sum() / cnt) if cnt else 0.0
    return avg, per_joint, cnt
