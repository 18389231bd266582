"""Batched Gaussian heatmap targets on the device.

Port of ``stlpose_tpu/ops/heatmap.py::generate_targets``: the reference's
windowed per-joint render (integer-quantised centre, a (6*sigma + 1)^2
patch, joints whose patch misses the map dropped) written analytically
over the whole (Hh, Hw) grid, with no loop and no data-dependent shape.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.constants import JOINT_LOSS_WEIGHTS


def generate_targets(joints, joints_vis, *, heatmap_size=(48, 64),
                     image_size=(192, 256), sigma=2.0,
                     use_joint_weights=True):
    """(N, J, 2) crop-pixel joints and (N, J) visibility -> target
    (N, J, Hh, Hw) f32 heatmaps and target_weight (N, J) (0 for dropped
    joints, times the per-joint loss weights when ``use_joint_weights``).
    ``heatmap_size`` and ``image_size`` are (w, h)."""
    Hw, Hh = heatmap_size
    Iw, Ih = image_size
    stride_x = Iw / Hw
    stride_y = Ih / Hh
    tmp_size = sigma * 3.0

    joints = torch.as_tensor(joints, dtype=torch.float32)
    vis = torch.as_tensor(joints_vis, dtype=torch.float32,
                          device=joints.device)
    dev = joints.device

    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5)
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5)
    ul_x, ul_y = mu_x - tmp_size, mu_y - tmp_size
    br_x, br_y = mu_x + tmp_size + 1.0, mu_y + tmp_size + 1.0

    inside = ~((ul_x >= Hw) | (ul_y >= Hh) | (br_x < 0) | (br_y < 0))
    weight = vis * inside.to(torch.float32)

    gx = torch.arange(Hw, dtype=torch.float32, device=dev)
    gy = torch.arange(Hh, dtype=torch.float32, device=dev)
    dx2 = (gx - mu_x[..., None]) ** 2                       # (N, J, Hw)
    dy2 = (gy - mu_y[..., None]) ** 2                       # (N, J, Hh)
    g = torch.exp(-(dy2[..., :, None] + dx2[..., None, :]) /
                  (2.0 * sigma ** 2))

    in_x = (gx >= ul_x[..., None]) & (gx < br_x[..., None])
    in_y = (gy >= ul_y[..., None]) & (gy < br_y[..., None])
    window = in_y[..., :, None] & in_x[..., None, :]        # (N, J, Hh, Hw)

    visible = (weight > 0.5)[..., None, None]
    target = torch.where(window & visible, g, 0.0)
    if use_joint_weights:
        weight = weight * torch.as_tensor(JOINT_LOSS_WEIGHTS, device=dev)
    return target, weight
