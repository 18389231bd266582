"""Closed-form batched affine crop geometry (f32, elementwise).

Port of ``stlpose_tpu/ops/affine.py``: the crop matrices of the reference
(``cv2.getAffineTransform`` on three point pairs) are similarities, so
they are computed in closed form. The inverse map is
``X = [[a, -b], [b, a]] @ x + (tx, ty)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Person scale is expressed in units of 200 px.
PIXEL_STD = 200.0


def get_affine_params(center, scale, rot_deg, output_size,
                      shift=(0.0, 0.0), inv: bool = False):
    """Batched (a, b, tx, ty) of the crop similarity.

    Args:
      center: (..., 2) person centre in source pixels.
      scale: (..., 2) person scale in pixel-std units (only w is used).
      rot_deg: (...,) rotation in degrees (tensor or number).
      output_size: static (dst_w, dst_h).
      shift: (2,) or (..., 2) shift in scale units.
      inv: the destination->source map when True.
    """
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    rot_rad = torch.as_tensor(rot_deg, dtype=torch.float32,
                              device=center.device) * (math.pi / 180.0)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=center.device)

    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scale[..., 0] * PIXEL_STD
    scale_tmp = scale * PIXEL_STD
    src_cx = center[..., 0] + scale_tmp[..., 0] * shift[..., 0]
    src_cy = center[..., 1] + scale_tmp[..., 1] * shift[..., 1]

    # cos and sin in float64, rounded once to f32: torch's f32 sin is an
    # ulp off XLA's at +-60 degrees, which moves a rotated crop's samples
    cs = torch.cos(rot_rad.double()).float()
    sn = torch.sin(rot_rad.double()).float()
    if not inv:
        lam = dst_w / src_w
        a = lam * cs
        b = -lam * sn
        tx = dst_w * 0.5 - (a * src_cx - b * src_cy)
        ty = dst_h * 0.5 - (b * src_cx + a * src_cy)
    else:
        lam = src_w / dst_w
        a = lam * cs
        b = lam * sn
        tx = src_cx - (a * dst_w * 0.5 - b * dst_h * 0.5)
        ty = src_cy - (b * dst_w * 0.5 + a * dst_h * 0.5)
    return a, b, tx, ty


def transform_preds(coords, center, scale, output_size):
    """Map (..., P, 2) heatmap-space coordinates back to source pixels
    through the inverse crop transform of (center, scale), rot 0."""
    a, b, tx, ty = get_affine_params(center, scale, 0.0, output_size,
                                     inv=True)
    a, b, tx, ty = (v[..., None] for v in (a, b, tx, ty))
    x, y = coords[..., 0], coords[..., 1]
    out_x = a * x + (-b) * y + tx
    out_y = b * x + a * y + ty
    return torch.stack([out_x, out_y], dim=-1)


def coords_to_center_scale(boxes, aspect_ratio, padding: float = 1.25,
                           pixel_std: float = PIXEL_STD):
    """(..., 4) xyxy boxes -> (center, scale): the box grows to the target
    aspect ratio and is padded 1.25x; scale is in pixel-std units."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)
    w, h = x2 - x1, y2 - y1
    cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
    h = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w = torch.maximum(w, h * aspect_ratio)
    scale = torch.stack([w, h], dim=-1) / pixel_std * padding
    center = torch.stack([cx, cy], dim=-1)
    return center, scale


def get_affine_matrix(center, scale, rot_deg, output_size,
                      shift=(0.0, 0.0), inv: bool = False):
    """Batched (..., 2, 3) crop matrices ``[[a, -b, tx], [b, a, ty]]``."""
    a, b, tx, ty = get_affine_params(center, scale, rot_deg, output_size,
                                     shift=shift, inv=inv)
    row0 = torch.stack([a, -b, tx], dim=-1)
    row1 = torch.stack([b, a, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def apply_affine(points, mat):
    """(..., 2, 3) matrices applied to (..., P, 2) points, elementwise in
    the reference's order (it avoids the TPU's reduced-precision f32
    matmul; here it keeps the two packages' rounding equal)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    x, y = points[..., 0], points[..., 1]
    m = mat[..., None, :, :]
    out_x = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2]
    out_y = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]
    return torch.stack([out_x, out_y], dim=-1)


def get_affine_matrix_np(center, scale, rot_deg, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """Host numpy (float64) crop matrix of one sample, for host paths."""
    center = np.asarray(center, np.float64)
    scale = np.asarray(scale, np.float64)
    shift = np.asarray(shift, np.float64)
    rot_rad = float(rot_deg) * np.pi / 180.0
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scale[0] * PIXEL_STD
    scale_tmp = scale * PIXEL_STD
    src_cx = center[0] + scale_tmp[0] * shift[0]
    src_cy = center[1] + scale_tmp[1] * shift[1]
    cs, sn = np.cos(rot_rad), np.sin(rot_rad)
    if not inv:
        lam = dst_w / src_w
        a, b = lam * cs, -lam * sn
        tx = dst_w * 0.5 - (a * src_cx - b * src_cy)
        ty = dst_h * 0.5 - (b * src_cx + a * src_cy)
    else:
        lam = src_w / dst_w
        a, b = lam * cs, lam * sn
        tx = src_cx - (a * dst_w * 0.5 - b * dst_h * 0.5)
        ty = src_cy - (b * dst_w * 0.5 + a * dst_h * 0.5)
    return np.array([[a, -b, tx], [b, a, ty]], np.float64)
