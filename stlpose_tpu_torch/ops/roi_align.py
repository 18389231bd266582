"""FPN RoIAlign over a batch of images.

Port of ``stlpose_tpu/ops/roi_align.py`` (``_assign_levels``,
``roi_align_single_level`` and the multilevel entry) and of the
``patch_quant`` option of ``stlpose_tpu/ops/pallas_roi.py::
multilevel_roi_align_pallas_batched``: each box reads only its canonically
assigned level. Sampling runs in the K3 kernel (``kernels/roi_align.py``),
the int8 quantization in the K3q kernels (``kernels/quantize.py``). Under
autograd (detector training) the f32 or bf16 maps get their gradient
from K3b, through ``kernels/roi_align.py::RoIAlignFunction``.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import quantize as _k3q
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


def quantize_levels(feature_levels):
    """Symmetric int8 quantization of each (B, h, w, C) level with one
    scale per (level, channel) over the whole batch, in the K3q kernels
    (``kernels/quantize.py``, whose ``quantize_levels_plain`` states the
    function). Returns (int8 levels, (L, C) f32 scales)."""
    return _k3q.quantize_levels(feature_levels)


def multilevel_roi_align(feature_levels, boxes, strides,
                         patch_quant: bool = False):
    """feature_levels: P2.. maps (B, h, w, C), float32 or bfloat16; boxes
    (B, P, 4) xyxy image pixels. Returns (B, P, 7, 7, C) in the maps'
    dtype. ``patch_quant`` pools from the int8 pyramid of
    ``quantize_levels`` and dequantizes each box exactly after pooling
    (RoIAlign is linear per channel and a box reads one level). When
    autograd records and a map requires grad, the f32 or bf16 maps are
    pooled through ``RoIAlignFunction`` (K3 forward, K3b backward, both in
    the maps' dtype; ``patch_quant`` raises); inference takes the bare K3
    call."""
    levels = _assign_levels(boxes, len(feature_levels))
    strides = strides[:len(feature_levels)]
    out_dtype = feature_levels[0].dtype
    if torch.is_grad_enabled() and any(f.requires_grad
                                       for f in feature_levels):
        if patch_quant:
            raise ValueError("multilevel_roi_align: no gradient through the "
                             "int8 patch pyramid")
        return _k3.RoIAlignFunction.apply(boxes, levels, strides,
                                          *feature_levels)
    if patch_quant:
        q, scales = quantize_levels(feature_levels)
        return _k3.roi_align(q, boxes, levels, strides, scales, out_dtype)
    return _k3.roi_align(feature_levels, boxes, levels, strides,
                         out_dtype=out_dtype)
