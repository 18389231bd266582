"""Box geometry for detection (xyxy float32).

Port of ``stlpose_tpu/ops/boxes.py``: IoU, delta encoding and decoding,
clipping, smooth-L1 and areas.
"""

from __future__ import annotations

import torch

# torchvision BoxCoder convention
BBOX_XFORM_CLIP = 4.135166556742356    # log(1000/16)


def box_iou(a, b):
    """Pairwise IoU between (..., N, 4) and (..., M, 4) xyxy boxes ->
    (..., N, M); leading dimensions broadcast."""
    area_a = box_area(a)
    area_b = box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)


def box_area(boxes):
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)


def encode_boxes(reference, proposals, weights=(1.0, 1.0, 1.0, 1.0)):
    """Encode reference (GT) boxes as deltas w.r.t. proposals/anchors."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = torch.clamp(proposals[..., 2] - proposals[..., 0], min=1e-6)
    ph = torch.clamp(proposals[..., 3] - proposals[..., 1], min=1e-6)
    gx = (reference[..., 0] + reference[..., 2]) * 0.5
    gy = (reference[..., 1] + reference[..., 3]) * 0.5
    gw = torch.clamp(reference[..., 2] - reference[..., 0], min=1e-6)
    gh = torch.clamp(reference[..., 3] - reference[..., 1], min=1e-6)
    return torch.stack([
        wx * (gx - px) / pw, wy * (gy - py) / ph,
        ww * torch.log(gw / pw), wh * torch.log(gh / ph)], dim=-1)


def smooth_l1(pred, target, beta: float = 1.0 / 9.0):
    """Elementwise smooth-L1 (Huber) of the detector's regression
    losses."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """Apply predicted deltas to anchors/proposals -> xyxy boxes."""
    wx, wy, ww, wh = weights
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    pw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    ph = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes, size_hw):
    """Clip xyxy boxes to [0, W] x [0, H]."""
    h, w = size_hw
    return torch.stack([
        boxes[..., 0].clamp(0.0, w), boxes[..., 1].clamp(0.0, h),
        boxes[..., 2].clamp(0.0, w), boxes[..., 3].clamp(0.0, h)], dim=-1)
