#!/usr/bin/env python
"""Person-detector COCO evaluation.

    python stlpose_tpu_torch/scripts/03_evaluate_faster_rcnn.py -d EXP
        [--checkpoint N|final] [--data_path DIR] [--device cuda|cpu]

Counterpart of ``scripts/03_evaluate_faster_rcnn.py``: ``DetectorEvaluator``
over the experiment's validation set, COCO bbox AP and the detector stats
JSON keyed by checkpoint. The environment is the reference's:
``STLPOSE_DETECTOR_CONFIG`` as for ``02_train_faster_rcnn.py``, and the
serving flavor, ``STLPOSE_DTYPE=bfloat16`` (bf16 compute),
``STLPOSE_FRCNN_TRUNK_QUANT=folded`` (BatchNorm folded into the trunk),
``int8`` or ``int8u`` (the folded trunk with its bottlenecks int8
post-training quantized, calibrated on the first validation batch; the
int8 convolution is kernel K6) and ``STLPOSE_PALLAS_ROI_INT8=1`` (the
int8 RoI patch pyramid); the last two are Faster R-CNN's only.
"""

import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.detector_trainer import DetectorEvaluator  # noqa: E402
from stlpose_tpu_torch.utils.arguments import (get_directory_argument,  # noqa: E402
                                               model_dtype)
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None):
    exp_path, args = get_directory_argument(argv, get_checkpoint=True,
                                            get_dataset=True)
    Logger(exp_path)
    print_("Starting detector evaluation", type="new_exp")
    ev = DetectorEvaluator(
        exp_path, checkpoint=args.checkpoint,
        dataset_name=args.dataset_name, data_path=args.data_path,
        detector_config=os.environ.get("STLPOSE_DETECTOR_CONFIG") or None,
        dtype=model_dtype(),
        trunk_quant=os.environ.get("STLPOSE_FRCNN_TRUNK_QUANT") or "none",
        roi_patch_quant=(os.environ.get("STLPOSE_PALLAS_ROI_INT8")
                         or "0") != "0",
        device=args.device)
    ev.setup()
    stats = ev.evaluate()
    print_(f"Detector AP: {stats[0]:.4f}")
    return stats


if __name__ == "__main__":
    main()
