"""FPN RoIAlign over a batch of images.

Port of ``stlpose_tpu/ops/roi_align.py`` (``_assign_levels``,
``roi_align_single_level`` and the multilevel entry): each box reads only
its canonically assigned level. Sampling runs in the K3 kernel
(``kernels/roi_align.py``).
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import roi_align as _k3


def _assign_levels(boxes, n_levels, canonical_scale=224.0,
                   canonical_level=4):
    """Canonical FPN level k = floor(k0 + log2(sqrt(area)/224)), clipped to
    the available levels; returned as a 0-based int32 index."""
    areas = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    k = torch.floor(canonical_level +
                    torch.log2(torch.sqrt(areas) / canonical_scale + 1e-8))
    return (torch.clamp(k, 2, 2 + n_levels - 1) - 2).to(torch.int32)


def multilevel_roi_align(feature_levels, boxes, strides):
    """feature_levels: P2.. maps (B, h, w, C); boxes (B, P, 4) xyxy image
    pixels. Returns (B, P, 7, 7, C)."""
    levels = _assign_levels(boxes, len(feature_levels))
    return _k3.roi_align(feature_levels, boxes, levels,
                         strides[:len(feature_levels)])
