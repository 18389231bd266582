"""Batched affine image warping.

``affine_warp``, ``crop_from_center_scale`` and
``crop_from_center_scale_batched`` port ``stlpose_tpu/ops/warp.py``: each
destination pixel is a bilinear sample of the source at the inverse crop
similarity, zero outside the image (cv2 BORDER_CONSTANT), on the K2
kernel (``kernels/warp.py``).
``affine_warp_two_pass`` ports ``stlpose_tpu/ops/pallas_warp.py::
affine_warp_pallas``, the two-pass filter of the rotated training crops,
on the K4 kernel (``kernels/warp_two_pass.py``): the same geometry, but
for a rotated crop another interpolant than K2's.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import warp as _k2
from stlpose_tpu_torch.kernels import warp_two_pass as _k4
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


def crop_from_center_scale(image, centers, scales, output_size):
    """K unrotated crops from ONE (H, W, C) image: K2 with every crop
    reading image 0. Port of ``stlpose_tpu/ops/warp.py::
    crop_from_center_scale`` and ``ops/pallas_warp.py::
    crop_from_center_scale_pallas``. Returns (K, dst_h, dst_w, C)."""
    img_idx = torch.zeros(centers.shape[0], dtype=torch.int32,
                          device=centers.device)
    return crop_from_center_scale_batched(image[None], centers, scales,
                                          img_idx, output_size)


def two_pass_params(center, scale, rot_deg, canvas_size, output_size,
                    may_rotate: bool = True):
    """(N, 8) f32 rows (u, r, txr, b, a, ty, swap, 0) for K4, computed in
    f32 in the order of ``affine_warp_pallas``: where |a| < |b| (and
    ``may_rotate``) the canvas counts as turned by 90 degrees and (a, b,
    tx, ty) become (b, -a, ty, S-1-tx); then r = b/a, u = a + b*r,
    txr = tx + r*ty."""
    a, b, tx, ty = get_affine_params(center, scale, rot_deg, output_size,
                                     inv=True)
    swap = torch.zeros_like(a, dtype=torch.bool)
    if may_rotate:
        swap = torch.abs(a) < torch.abs(b)
        a, b, tx, ty = (torch.where(swap, b, a), torch.where(swap, -a, b),
                        torch.where(swap, ty, tx),
                        torch.where(swap, (canvas_size - 1.0) - tx, ty))
    r = b / a
    zero = torch.zeros_like(a)
    return torch.stack([a + b * r, r, tx + r * ty, b, a, ty,
                        swap.to(torch.float32), zero], dim=1).contiguous()


def affine_warp_two_pass(images, center, scale, rot_deg, output_size,
                         may_rotate: bool = True):
    """(N, S, S, C) uint8 or f32 square canvases -> (N, dst_h, dst_w, C)
    f32 crops through the two-pass filter, crop n from canvas n.

    ``may_rotate=False`` promises |rot| <= 45 degrees (an unaugmented
    pipeline, where rot is 0) and skips the conditioning test."""
    N, S, S2, _ = images.shape
    if S != S2:
        raise ValueError(f"affine_warp_two_pass: canvas must be square, "
                         f"got {S}x{S2}")
    params = two_pass_params(center, scale, rot_deg, S, output_size,
                             may_rotate)
    return _k4.warp_two_pass(images, params, output_size)
