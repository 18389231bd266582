#!/usr/bin/env python
"""Person-detector fine-tuning.

    python stlpose_tpu_torch/scripts/02_train_faster_rcnn.py -d EXP
        [--checkpoint N|final [--resume_training true]]
        [--use_perceptual_loss true] [--data_path DIR] [--device cuda|cpu]

Counterpart of ``scripts/02_train_faster_rcnn.py``: ``DetectorTrainer`` on
the experiment, the summed detector loss (optionally perceptually
weighted), COCO bbox AP validation before each epoch with plateau-on-AP
scheduling, ``detector_logs.json`` and checkpoints under
``models/detector/``. Training runs the live trunk in f32. The environment
is the reference's: ``STLPOSE_DETECTOR_CONFIG`` (faster_rcnn,
faster_rcnn_tiny, faster_rcnn_torchvision_parity, efficientdet,
efficientdet_d0, efficientdet_d3 or efficientdet_tiny; default the
experiment's ``model.detector_name``, with ``model.detector_type``),
``STLPOSE_DETECTOR_PRETRAINED`` (a torchvision fasterrcnn_resnet50_fpn or
a zylo117 efficientdet-d{0,3} ``.pth``; empty for none) and the
``STLPOSE_*_PATH`` directories.
"""

import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.detector_trainer import DetectorTrainer  # noqa: E402
from stlpose_tpu_torch.utils.arguments import get_directory_argument  # noqa: E402
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None) -> DetectorTrainer:
    exp_path, args = get_directory_argument(argv, get_checkpoint=True,
                                            get_dataset=True)
    Logger(exp_path)
    print_("Starting detector training", type="new_exp")
    trainer = DetectorTrainer(
        exp_path, checkpoint=args.checkpoint,
        resume_training=args.resume_training,
        dataset_name=args.dataset_name, data_path=args.data_path,
        use_perceptual_loss=args.use_perceptual_loss,
        detector_config=os.environ.get("STLPOSE_DETECTOR_CONFIG") or None,
        device=args.device)
    trainer.load_dataset()
    trainer.setup_model(
        pretrained=os.environ.get("STLPOSE_DETECTOR_PRETRAINED") or None)
    trainer.training_loop()
    return trainer


if __name__ == "__main__":
    main()
