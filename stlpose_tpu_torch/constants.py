"""COCO-17 keypoint tables the training slice needs (own copy of the
parts of ``stlpose_tpu/constants.py`` that the pose pipeline and loss
read)."""

from __future__ import annotations

import numpy as np

COCO_KPT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

# Left/right index pairs swapped under horizontal mirroring.
FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
              (15, 16))

UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)

# Per-joint loss weights: 1.2 elbows/knees, 1.5 wrists/ankles.
JOINT_LOSS_WEIGHTS = np.array(
    [1.0, 1.0, 1.0, 1.0, 1.0,
     1.0, 1.0, 1.2, 1.2,
     1.5, 1.5, 1.0, 1.0,
     1.2, 1.2, 1.5, 1.5],
    dtype=np.float32,
)
