"""Static-shape greedy IoU NMS and the top-k used around it.

Port of ``stlpose_tpu/ops/nms.py::_box_nms_topk`` (``box_nms_jax`` with
``max_keep``): ``max_keep`` sequential picks over a (B, M) candidate set,
batched over images. It has no Pallas original; the loop is the port's
own kernel K5 (``kernels/nms.py``), one launch per call.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import nms as _k5


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (torch.topk
    promises no order for ties, and -inf-masked or zero keys tie on every
    call). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def box_nms_topk(boxes, scores, iou_threshold: float, valid_mask,
                 max_keep: int):
    """Pick-argmax greedy NMS, batched: boxes (B, M, 4) xyxy, scores
    (B, M), valid_mask (B, M) bool or None. Returns the (B, M) keep mask
    of the first ``max_keep`` greedy survivors (lowest index on tied
    scores). K5 on the card, its plain version on the CPU
    (``kernels/nms.py``)."""
    return _k5.box_nms_topk(boxes, scores, iou_threshold, valid_mask,
                            max_keep)
