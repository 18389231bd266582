"""Batched affine image warping.

Port of ``stlpose_tpu/ops/warp.py``: each destination pixel is a bilinear
sample of the source at the inverse crop similarity, zero outside the
image (cv2 BORDER_CONSTANT). Every entry reaches the K2 kernel
(``kernels/warp.py``).
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import warp as _k2
from stlpose_tpu_torch.ops.affine import get_affine_params


def _inverse_params(centers, scales, rot_deg, output_size):
    a, b, tx, ty = get_affine_params(centers, scales, rot_deg, output_size,
                                     inv=True)
    return torch.stack([a, b, tx, ty], dim=-1).contiguous()


def affine_warp(images, center, scale, rot_deg, output_size):
    """(N, H, W, C) images -> (N, dst_h, dst_w, C) crops, crop n from
    image n, with per-crop rotation ``rot_deg`` (N,)."""
    N = images.shape[0]
    params = _inverse_params(center, scale, rot_deg, output_size)
    idx = torch.arange(N, dtype=torch.int32, device=images.device)
    return _k2.affine_crop(images, params, idx, output_size)


def crop_from_center_scale_batched(images, centers, scales, img_idx,
                                   output_size):
    """K unrotated crops from a batch of images: crop k reads
    ``images[img_idx[k]]`` (cross-batch crop compaction).

    images (B, H, W, C); centers/scales (K, 2); img_idx (K,) int.
    Returns (K, dst_h, dst_w, C)."""
    params = _inverse_params(centers, scales,
                             torch.zeros(centers.shape[0],
                                         device=centers.device),
                             output_size)
    return _k2.affine_crop(images, params, img_idx, output_size)
