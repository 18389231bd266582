"""OKS and IoU non-maximum suppression.

Port of ``stlpose_tpu/ops/nms.py``. The host half (``oks_iou``,
``oks_nms``, ``box_nms``, ``soft_oks_nms``) is numpy, as in the
reference: greedy keep order decides COCO AP, and the evaluator runs it
per image on the host. The device half is ``_box_nms_topk``
(``box_nms_jax`` with ``max_keep``): ``max_keep`` sequential picks over a
(B, M) candidate set, batched over images. It has no Pallas original; the
loop is the port's own kernel K5 (``kernels/nms.py``), one launch per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch import constants
from stlpose_tpu_torch.kernels import nms as _k5


def oks_iou(g, d, a_g, a_d, sigmas=None, in_vis_thre=None):
    """OKS between one pose ``g`` (51,) and poses ``d`` (M, 51).

    With ``in_vis_thre`` set, keypoints count where both the pose's and the
    candidate's visibility pass it, averaged over that count: the
    elementwise AND the reference's ``list(vg > t) and list(vd > t)``
    (which keeps the candidate's mask only) plainly intended. Every caller
    in the repository passes ``None``."""
    if sigmas is None:
        sigmas = constants.OKS_SIGMAS
    var = (np.asarray(sigmas) * 2.0) ** 2
    g = np.asarray(g, np.float64)
    d = np.asarray(d, np.float64).reshape(len(d), len(g))
    if d.shape[0] == 0:
        return np.zeros((0,))
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    xd, yd, vd = d[:, 0::3], d[:, 1::3], d[:, 2::3]
    denom = ((a_g + np.asarray(a_d)) / 2.0 + np.spacing(1))[:, None]
    e = ((xd - xg) ** 2 + (yd - yg) ** 2) / var[None, :] / denom / 2.0
    if in_vis_thre is not None:
        mask = (vg[None, :] > in_vis_thre) & (vd > in_vis_thre)
        cnt = mask.sum(axis=1)
        s = np.where(mask, np.exp(-e), 0.0).sum(axis=1)
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return np.exp(-e).mean(axis=1)


def _pose_arrays(kpts_db):
    scores = np.array([k["score"] for k in kpts_db], np.float64)
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db], np.float64)
    return scores, kpts, areas


def oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None):
    """Greedy OKS-NMS over a list of {'score', 'keypoints', 'area'} dicts;
    returns the kept indices in pick order."""
    if len(kpts_db) == 0:
        return []
    scores, kpts, areas = _pose_arrays(kpts_db)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[1:][ovr <= thresh]
    return keep


def box_nms(dets, thresh):
    """Greedy IoU NMS over (M, 5) [x1, y1, x2, y2, score] boxes, with the
    +1 pixel area convention; returns the kept indices in pick order."""
    dets = np.asarray(dets, np.float64)
    if dets.shape[0] == 0:
        return []
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2],
                              dets[:, 3], dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[rest] - inter)
        order = rest[ovr <= thresh]
    return keep


def soft_oks_nms(kpts_db, thresh, max_dets: int = 20, sigmas=None,
                 in_vis_thre=None):
    """Soft OKS-NMS: overlapping poses are not dropped but their scores
    decay by exp(-oks^2 / thresh) before the next pick. Returns up to
    ``max_dets`` kept indices in pick order."""
    if len(kpts_db) == 0:
        return []
    scores, kpts, areas = _pose_arrays(kpts_db)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0 and len(keep) < max_dets:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        oks = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        scores[order[1:]] *= np.exp(-(oks ** 2) / thresh)
        rest = order[1:]
        order = rest[scores[rest].argsort()[::-1]]
    return keep


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
