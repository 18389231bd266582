"""Detection post-processing on the host.

Port of ``stlpose_tpu/ops/bbox_utils.py``: score and class filtering of a
detector's padded {boxes, labels, scores, valid} output, greedy IoU NMS
over the filtered boxes, and the box-stretch mapping of crop keypoints to
the image. Host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from stlpose_tpu_torch.ops.nms import box_nms


def bbox_filtering(detections, filter_class: int = 1, thr: float = 0.5):
    """Keep the detections of one class at or above a score threshold.

    Args:
      detections: dict of numpy arrays {boxes (N, D, 4), labels (N, D),
        scores (N, D), valid (N, D)} or a single-image variant without N.
    Returns per-image (boxes, labels, scores); one tuple for a single
    image.
    """
    boxes = np.asarray(detections["boxes"])
    labels = np.asarray(detections["labels"])
    scores = np.asarray(detections["scores"])
    valid = np.asarray(detections.get("valid", np.ones(scores.shape, bool)))
    single = boxes.ndim == 2
    if single:
        boxes, labels, scores, valid = (boxes[None], labels[None],
                                        scores[None], valid[None])
    out = []
    for i in range(len(boxes)):
        keep = valid[i] & (labels[i] == filter_class) & (scores[i] >= thr)
        out.append((boxes[i][keep], labels[i][keep], scores[i][keep]))
    return out[0] if single else out


def bbox_nms(boxes, labels, scores, nms_thr: float = 0.5):
    """Greedy IoU NMS over filtered boxes (float64, +1 pixel areas)."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    if len(boxes) == 0:
        return boxes, np.asarray(labels), scores
    dets = np.concatenate([boxes, scores[:, None]], axis=1)
    keep = box_nms(dets, nms_thr)
    return boxes[keep], np.asarray(labels)[keep], scores[keep]


def bbox_to_image_keypoints(keypoints, boxes, crop_size=(192, 256)):
    """Crop-space keypoints (K, J, >=2) to image pixels by stretching the
    crop onto each xyxy box (K, 4); the affine-correct mapping is
    ``ops/decode.py::decode_heatmaps`` with centre and scale."""
    keypoints = np.asarray(keypoints, np.float64).copy()
    boxes = np.asarray(boxes, np.float64)
    cw, ch = crop_size
    for k in range(len(keypoints)):
        x1, y1, x2, y2 = boxes[k][:4]
        sx, sy = (x2 - x1) / cw, (y2 - y1) / ch
        keypoints[k, :, 0] = keypoints[k, :, 0] * sx + x1
        keypoints[k, :, 1] = keypoints[k, :, 1] * sy + y1
    return keypoints
