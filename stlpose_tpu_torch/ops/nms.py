"""Static-shape greedy IoU NMS and the top-k used around it.

Port of ``stlpose_tpu/ops/nms.py::_box_nms_topk`` (``box_nms_jax`` with
``max_keep``). It has no Pallas original and stays plain PyTorch, batched
over images: ``max_keep`` sequential picks over a (B, M) candidate set.
"""

from __future__ import annotations

import torch


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (torch.topk
    promises no order for ties, and -inf-masked or zero keys tie on every
    call). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def box_nms_topk(boxes, scores, iou_threshold: float, valid_mask,
                 max_keep: int):
    """Pick-argmax greedy NMS, batched.

    boxes (B, M, 4) xyxy; scores (B, M); valid_mask (B, M) bool or None.
    Each of ``max_keep`` iterations picks the best alive candidate per
    image (lowest index on ties, as torch.argmax returns the first max),
    keeps it, and removes it and every alive box with IoU above the
    threshold. Returns the (B, M) keep mask: the first ``max_keep`` greedy
    survivors."""
    B, M = scores.shape
    max_keep = min(max_keep, M)
    if valid_mask is None:
        valid_mask = torch.ones_like(scores, dtype=torch.bool)
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    alive = valid_mask & (scores > -torch.inf)
    keep = torch.zeros_like(alive)
    idx = torch.arange(M, device=scores.device)
    neg_inf = torch.tensor(-torch.inf, device=scores.device)
    for _ in range(max_keep):
        i = torch.argmax(torch.where(alive, scores, neg_inf), dim=1,
                         keepdim=True)                              # (B, 1)
        ok = torch.gather(alive, 1, i)                              # (B, 1)
        bx = torch.gather(boxes, 1, i[..., None].expand(B, 1, 4))[:, 0]
        inter = (torch.clamp(torch.minimum(x2, bx[:, 2:3]) -
                             torch.maximum(x1, bx[:, 0:1]), min=0.0) *
                 torch.clamp(torch.minimum(y2, bx[:, 3:4]) -
                             torch.maximum(y1, bx[:, 1:2]), min=0.0))
        area_i = torch.gather(areas, 1, i)
        iou = inter / torch.clamp(areas + area_i - inter, min=1e-9)
        picked = idx[None, :] == i
        keep = keep | (picked & ok)
        # the pick is removed explicitly: a zero-area box has self-IoU 0
        # and would otherwise be picked again on every iteration
        alive = torch.where(ok, alive & ~(iou > iou_threshold) & ~picked,
                            alive)
    return keep
