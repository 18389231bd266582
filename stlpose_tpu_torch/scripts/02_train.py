#!/usr/bin/env python
"""HRNet fine-tuning.

    python stlpose_tpu_torch/scripts/02_train.py -d EXP [--checkpoint N|final
        [--resume_training true]] [--use_perceptual_loss true]
        [--data_path DIR] [--device cuda|cpu]

Counterpart of ``scripts/02_train.py``: ``PoseTrainer`` on the experiment,
validate-before-train epochs, JSON logs, plots, TensorBoard scalars and
checkpoints. A checkpoint without ``--resume_training`` gives the starting
weights only. The environment is the reference's: ``STLPOSE_MODEL_CONFIG``
(default w32_256x192), ``STLPOSE_PRETRAINED`` (a reference-format
``.pth``; empty for none), ``STLPOSE_DTYPE=bfloat16`` (bf16 compute on f32
master weights) and the ``STLPOSE_*_PATH`` directories.
"""

import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.trainer import PoseTrainer  # noqa: E402
from stlpose_tpu_torch.utils.arguments import (get_directory_argument,  # noqa: E402
                                               model_dtype)
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None) -> PoseTrainer:
    exp_path, args = get_directory_argument(argv, get_checkpoint=True,
                                            get_dataset=True)
    Logger(exp_path)
    print_("Starting HRNet training", type="new_exp")
    trainer = PoseTrainer(exp_path, checkpoint=args.checkpoint,
                          resume_training=args.resume_training,
                          dataset_name=args.dataset_name,
                          data_path=args.data_path,
                          use_perceptual_loss=args.use_perceptual_loss,
                          dtype=model_dtype(), device=args.device)
    trainer.load_dataset()
    trainer.setup_model(
        config_name=os.environ.get("STLPOSE_MODEL_CONFIG", "w32_256x192"),
        pretrained=os.environ.get("STLPOSE_PRETRAINED", "default"))
    trainer.training_loop()
    return trainer


if __name__ == "__main__":
    main()
