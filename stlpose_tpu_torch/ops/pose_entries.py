"""Pose-entry bookkeeping and COCO-format conversion on the host.

Port of ``stlpose_tpu/ops/pose_entries.py``: ``create_pose_entries`` turns
per-person keypoint arrays into the flat indexed (pose_entries,
all_keypoints) form, ``convert_to_coco_format`` flattens entries into COCO
result keypoint lists, and ``unnormalize`` undoes the ImageNet
normalisation of a crop for drawing.
"""

from __future__ import annotations

import numpy as np

from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

POSE_ENTRY_SIZE = 19      # 17 keypoint slots + score + count


def create_pose_entries(keypoints, max_vals=None, thr: float = 0.1):
    """Keypoint arrays -> (pose_entries, all_keypoints).

    Args:
      keypoints: (P, 17, 2) per-person keypoint coords, -1 for missing.
      max_vals: optional (P, 17) confidences; keypoints below ``thr`` get
        their validity flag zeroed.
    Returns:
      pose_entries: list of (19,) arrays: 17 indices into all_keypoints
        (or -1), then the pose score, then the visible count.
      all_keypoints: (P*17, 4) rows (x, y, 1, flag).
    """
    keypoints = np.asarray(keypoints, np.float64)
    P = len(keypoints)
    if P == 0:
        return [], np.zeros((0, 4))
    flat = keypoints.reshape(-1, 2)
    all_keypoints = np.concatenate(
        [flat, np.ones((len(flat), 2))], axis=1)
    missing = (flat == -1).any(axis=1)
    all_keypoints[missing] = -1
    if max_vals is not None:
        mv = np.asarray(max_vals).reshape(-1)
        all_keypoints[mv < thr, -1] = 0

    pose_entries = []
    for p in range(P):
        entry = np.full(POSE_ENTRY_SIZE, -1.0)
        for j in range(17):
            if keypoints[p, j, 0] != -1:
                entry[j] = 17 * p + j
        # [-2] = pose score, [-1] = visible count. The original code wrote
        # the count into [-2] twice and left [-1] at -1, which zeroes every
        # score in its converter; the JAX package repairs that, and so
        # does this copy.
        entry[-2] = 1.0
        entry[-1] = float((entry[:-2] != -1).sum())
        pose_entries.append(entry)
    return pose_entries, all_keypoints


def convert_to_coco_format(pose_entries, all_keypoints):
    """Pose entries -> COCO keypoint lists (51 floats each) and scores
    (pose score x (visible count - 1)); one all-zero person for no
    entries."""
    coco_keypoints, scores = [], []
    for entry in pose_entries:
        if len(entry) == 0:
            continue
        kps = [0.0] * (17 * 3)
        person_score = float(entry[-2])
        for pos, kid in enumerate(entry[:-2]):
            if pos >= 17:
                break
            if kid != -1:
                x, y, _ = all_keypoints[int(kid), 0:3]
                kps[pos * 3 + 0] = float(x)
                kps[pos * 3 + 1] = float(y)
                kps[pos * 3 + 2] = 1.0
        coco_keypoints.append(kps)
        scores.append(person_score * max(0.0, float(entry[-1]) - 1))
    if len(pose_entries) == 0:
        coco_keypoints.append([0.0] * 51)
        scores.append(0.0)
    return coco_keypoints, scores


def unnormalize(img, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Undo the ImageNet normalisation: a [0, 1] image (one whose maximum
    is above 50 is taken as 0-255 and divided by 255)."""
    img = np.asarray(img, np.float32)
    if img.max() > 50:
        return img / 255.0
    return np.clip(img * np.asarray(std, np.float32) +
                   np.asarray(mean, np.float32), 0.0, 1.0)
