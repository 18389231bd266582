"""Person-detector factory.

Port of ``stlpose_tpu/engines/detector_trainer.py::build_detector`` and
its ``DETECTOR_CONFIGS``: an experiment's detector name (or an explicit
config name) -> a ``FasterRCNN`` and its config. The serving flavors are
arguments, where the JAX factory and detector read ``STLPOSE_DTYPE``,
``STLPOSE_FRCNN_TRUNK_QUANT`` and ``STLPOSE_PALLAS_ROI_INT8``. The
EfficientDet names are refused until EfficientDet is ported (ROADMAP
Queue 1 item 6); detector training (``DetectorTrainer``) comes with item
5.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.config import (FASTER_RCNN_TINY,
                                      FASTER_RCNN_TORCHVISION_PARITY,
                                      FasterRCNNConfig)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN

DETECTOR_CONFIGS = {
    # the serving budgets (pre/post NMS 500/256, 64 detections an image)
    "faster_rcnn": FasterRCNNConfig(),
    "faster_rcnn_tiny": FASTER_RCNN_TINY,
    # torchvision's test-time budgets, for AP-parity evaluation
    "faster_rcnn_torchvision_parity": FASTER_RCNN_TORCHVISION_PARITY,
}
EFFICIENTDET_NAMES = ("efficientdet", "efficientdet_d0", "efficientdet_d3",
                      "efficientdet_tiny")


def build_detector(exp_data: dict, config_name: str | None = None, *,
                   dtype=torch.float32, trunk_quant: str = "none",
                   roi_patch_quant: bool = False, device="cuda"):
    """(detector, config) for ``config_name``, or the experiment's
    ``model.detector_name`` (with ``model.detector_type`` d0/d3 naming an
    EfficientDet), built on ``device`` in the given flavor with the
    default initialisation of its modules."""
    name = config_name or exp_data["model"].get("detector_name",
                                                "faster_rcnn")
    det_type = exp_data["model"].get("detector_type", "")
    if name == "efficientdet" and det_type in ("d0", "d3"):
        name = f"efficientdet_{det_type}"
    if name in EFFICIENTDET_NAMES:
        raise NotImplementedError(
            f"Detector '{name}': EfficientDet is not ported yet; it comes "
            "with ROADMAP Queue 1 item 6")
    if name not in DETECTOR_CONFIGS:
        raise ValueError(f"Detector '{name}' not supported; available: "
                         f"{list(DETECTOR_CONFIGS) + list(EFFICIENTDET_NAMES)}")
    cfg = DETECTOR_CONFIGS[name]
    return FasterRCNN(cfg, device, dtype, roi_patch_quant, trunk_quant), cfg
