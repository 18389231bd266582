"""Model configurations of the ported slice (own copies; the port imports
nothing from the JAX package).

Counterparts: ``stlpose_tpu/config.py`` (HRNet) and
``stlpose_tpu/models/faster_rcnn.py`` (FasterRCNNConfig), plus the
ImageNet normalisation of ``stlpose_tpu/engines/vase_evaluator.py``. Only
the fields that inference reads are copied; training fields come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

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


FASTER_RCNN_TINY = FasterRCNNConfig(
    stage_sizes=(1, 1, 1, 1), width=8, fpn_channels=32, image_size=128,
    pre_nms_top_n_test=64, post_nms_top_n_test=32, detections_per_img=8)
