"""FPN RoIAlign over a batch of images.

Port of ``stlpose_tpu/ops/roi_align.py`` (``_assign_levels``,
``roi_align_single_level`` and the multilevel entry) and of the
``patch_quant`` option of ``stlpose_tpu/ops/pallas_roi.py::
multilevel_roi_align_pallas_batched``: each box reads only its canonically
assigned level. Sampling runs in the K3 kernel (``kernels/roi_align.py``).
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


def quantize_levels(feature_levels):
    """Symmetric int8 quantization of each (B, h, w, C) level with one
    scale per (level, channel), taken over the whole batch (the absmax
    runs over B, h and w, so one image's pooled features depend on the
    other images of the batch, as in the JAX package). In f32:
    ``s = max(absmax, 1e-8) / 127``, ``q = clip(round(x / s), -127, 127)``
    with round half to even. Returns (int8 levels, (L, C) f32 scales).

    Own copy of ``stlpose_tpu/ops/pallas_roi.py:418-429``. The JAX
    wrapper skips quantization when C % 128 != 0 outside interpret mode
    (Mosaic's lane-tile limit); this function quantizes at every C."""
    q, scales = [], []
    for f in feature_levels:
        x = f.to(torch.float32)
        # device tensors, not Python numbers: CUDA divides by a host
        # scalar as a multiply by its reciprocal, one rounding off
        s = torch.clamp(x.abs().amax(dim=(0, 1, 2)), min=1e-8) / \
            torch.tensor(127.0, device=x.device)
        q.append(torch.clamp(torch.round(x / s), -127, 127).to(torch.int8))
        scales.append(s)
    return q, torch.stack(scales)


def multilevel_roi_align(feature_levels, boxes, strides,
                         patch_quant: bool = False):
    """feature_levels: P2.. maps (B, h, w, C), float32 or bfloat16; boxes
    (B, P, 4) xyxy image pixels. Returns (B, P, 7, 7, C) in the maps'
    dtype. ``patch_quant`` pools from the int8 pyramid of
    ``quantize_levels`` and dequantizes each box exactly after pooling
    (RoIAlign is linear per channel and a box reads one level)."""
    levels = _assign_levels(boxes, len(feature_levels))
    strides = strides[:len(feature_levels)]
    out_dtype = feature_levels[0].dtype
    if patch_quant:
        q, scales = quantize_levels(feature_levels)
        return _k3.roi_align(q, boxes, levels, strides, scales, out_dtype)
    return _k3.roi_align(feature_levels, boxes, levels, strides,
                         out_dtype=out_dtype)
