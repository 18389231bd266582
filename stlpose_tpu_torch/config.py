"""Configuration of the port (own copies; the port imports nothing from
the JAX package).

Counterparts in ``stlpose_tpu/config.py``: the path table ``CONFIG`` (the
same ``STLPOSE_*`` environment names, which give paths, not switches),
the experiment defaults ``DEFAULT_ARGS`` and the HRNet configs; plus
``FasterRCNNConfig`` of ``stlpose_tpu/models/faster_rcnn.py`` and the
ImageNet normalisation of ``stlpose_tpu/engines/vase_evaluator.py``. Only
the model fields that the port reads are copied.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Tuple

import numpy as np

# Filesystem layout, as in the JAX package.
CONFIG = {
    "paths": {
        "data_path": os.environ.get("STLPOSE_DATA_PATH", "../../data"),
        "database_path": os.environ.get("STLPOSE_DATABASE_PATH",
                                        "../databases"),
        "experiments_path": os.environ.get("STLPOSE_EXPERIMENTS_PATH",
                                           "../experiments"),
        "comparisons_path": "../experiments/model_comparison",
        "knn_path": os.environ.get("STLPOSE_KNN_PATH", "../knn"),
        "pretrained_path": os.environ.get("STLPOSE_PRETRAINED_PATH",
                                          "../resources"),
        "dict_path": "../../data/mapping_dicts",
        "submission": "submission_dict.json",
    },
    "num_workers": int(os.environ.get("STLPOSE_NUM_WORKERS", "8")),
    "random_seed": 13,
}

# Per-experiment defaults, as in the JAX package, plus ``device_warp``,
# which the JAX pipeline reads with a default of False: host warp, with
# cv2, which the card's machine does not have, so an experiment run there
# sets it true.
DEFAULT_ARGS = {
    "dataset": {
        "dataset_name": "coco",
        "image_size": 400,
        "alpha": "0.5",
        "styles": "redblack",
        "flip": False,
        "num_joints_half_body": 8,
        "prob_half_body": 0,
        "rot_factor": 0,
        "scale_factor": 0.0,
        "test_set": "val2017",
        "train_set": "train2017",
        "shuffle_train": False,
        "shuffle_test": False,
        "inline_style": None,
        "device_warp": False,
    },
    "model": {
        "model_name": "HRNet",
        "detector_name": "faster_rcnn",
        "detector_type": "",
    },
    "training": {
        "num_epochs": 100,
        "learning_rate": 0.001,
        "learning_rate_factor": 0.333,
        "patience": 10,
        "scheduler": "plateau",
        "batch_size": 32,
        "save_frequency": 5,
        "log_frequency": 100,
        "optimizer": "adam",
        "momentum": 0.9,
        "nesterov": False,
        "gamma1": 0.9,
        "gamma2": 0.99,
        "lambda_D": None,
        "lambda_P": None,
        "perceptual_loss": False,
        "perceptual_weight": "add",
    },
    "evaluation": {
        "bbox_thr": 0.5,
        "det_nms_thr": 0.5,
        "img_thr": 0.0,
        "in_vis_thr": 0.2,
        "nms_thr": 1.0,
        "oks_thr": 0.9,
        "use_gt_bbox": True,
    },
}


def default_experiment_args() -> dict:
    """Deep copy of the experiment defaults (callers mutate their copy)."""
    return copy.deepcopy(DEFAULT_ARGS)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class HRNetStageConfig:
    num_modules: int
    num_branches: int
    num_blocks: Tuple[int, ...]     # BasicBlocks per branch
    num_channels: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    """HRNet-W32 pose config: (N, 256, 192, 3) crops -> (N, 64, 48, J)
    heatmaps (stride 4)."""
    num_joints: int = 17
    final_conv_kernel: int = 1
    stem_channels: int = 64
    stage1_num_blocks: int = 4
    stage2: HRNetStageConfig = HRNetStageConfig(1, 2, (4, 4), (32, 64))
    stage3: HRNetStageConfig = HRNetStageConfig(4, 3, (4, 4, 4), (32, 64, 128))
    stage4: HRNetStageConfig = HRNetStageConfig(
        3, 4, (4, 4, 4, 4), (32, 64, 128, 256))


HRNET_W32_256x192 = HRNetConfig()

# Same topology, thin channels (tests).
HRNET_TINY = HRNetConfig(
    stem_channels=16,
    stage1_num_blocks=1,
    stage2=HRNetStageConfig(1, 2, (1, 1), (8, 16)),
    stage3=HRNetStageConfig(1, 3, (1, 1, 1), (8, 16, 32)),
    stage4=HRNetStageConfig(1, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
)


def get_hrnet_config(name: str = "w32_256x192") -> HRNetConfig:
    table = {"w32_256x192": HRNET_W32_256x192, "tiny": HRNET_TINY}
    if name not in table:
        raise KeyError(f"Unknown HRNet config '{name}'; available: {list(table)}")
    return table[name]


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    """Faster R-CNN ResNet-FPN serving configuration."""
    num_classes: int = 2                   # background + person
    image_size: int = 400                  # square canvas side
    stage_sizes: tuple = (3, 4, 6, 3)
    width: int = 64
    fpn_channels: int = 256
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    strides: tuple = (4, 8, 16, 32, 64)
    pre_nms_top_n_test: int = 500
    post_nms_top_n_test: int = 256
    rpn_nms_thresh: float = 0.7
    box_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 64


# torchvision's fasterrcnn_resnet50_fpn test-time budgets (pre/post NMS
# 1000/1000, 100 detections an image), for AP-parity evaluation; the
# default above keeps the tighter serving budgets
FASTER_RCNN_TORCHVISION_PARITY = FasterRCNNConfig(
    pre_nms_top_n_test=1000, post_nms_top_n_test=1000,
    detections_per_img=100)

FASTER_RCNN_TINY = FasterRCNNConfig(
    stage_sizes=(1, 1, 1, 1), width=8, fpn_channels=32, image_size=128,
    pre_nms_top_n_test=64, post_nms_top_n_test=32, detections_per_img=8)
