"""Heatmap decoding: argmax -> sub-pixel refinement -> un-warp.

Port of ``stlpose_tpu/ops/decode.py``. Every function reaches the K1
kernel (``kernels/decode.py``) for its peaks.
"""

from __future__ import annotations

from stlpose_tpu_torch.kernels import decode as _k1
from stlpose_tpu_torch.ops.affine import transform_preds


def heatmap_argmax(heatmaps):
    """(N, J, H, W) -> coords (N, J, 2) (x, y), zeroed where the peak is
    <= 0, and maxvals (N, J)."""
    coords, maxvals, _ = _k1.heatmap_peaks(heatmaps)
    return coords, maxvals


def decode_heatmaps(heatmaps, center, scale, post_process: bool = True):
    """Argmax + quarter-pixel shift + inverse affine to image pixels.

    heatmaps (N, J, H, W); center, scale (N, 2). Returns preds (N, J, 2),
    maxvals (N, J) and the refined heatmap-space coords (N, J, 2)."""
    H, W = heatmaps.shape[2], heatmaps.shape[3]
    coords, maxvals, shift = _k1.heatmap_peaks(heatmaps)
    if post_process:
        coords = coords + shift
    preds = transform_preds(coords, center, scale, (W, H))
    return preds, maxvals, coords


def decode_heatmaps_nhwc(heatmaps_nhwc, center, scale,
                         post_process: bool = True):
    """:func:`decode_heatmaps` on the model's (N, H, W, J) output, read in
    place through strides (no transposed copy)."""
    return decode_heatmaps(heatmaps_nhwc.permute(0, 3, 1, 2), center, scale,
                           post_process)
