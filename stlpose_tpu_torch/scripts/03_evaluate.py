#!/usr/bin/env python
"""HRNet COCO evaluation.

    python stlpose_tpu_torch/scripts/03_evaluate.py -d EXP [--checkpoint N|final]
        [--flip true] [--data_path DIR] [--device cuda|cpu]

Counterpart of ``scripts/03_evaluate.py``: ``PoseEvaluator`` over the
experiment's validation set (flip-TTA unless ``--flip false``), the
submission file, COCO keypoint AP and the stats JSON keyed by checkpoint.
``--save true`` (visualisations) raises ``NotImplementedError`` until
``utils/visualization.py`` is ported. Environment as for ``02_train.py``.
"""

import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.evaluator import PoseEvaluator  # noqa: E402
from stlpose_tpu_torch.utils.arguments import (get_directory_argument,  # noqa: E402
                                               model_dtype)
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None):
    exp_path, args = get_directory_argument(argv, get_checkpoint=True,
                                            get_dataset=True)
    Logger(exp_path)
    print_("Starting HRNet evaluation", type="new_exp")
    evaluator = PoseEvaluator(exp_path, checkpoint=args.checkpoint,
                              dataset_name=args.dataset_name,
                              data_path=args.data_path, flip=args.flip,
                              save_visualizations=args.save,
                              dtype=model_dtype(), device=args.device)
    evaluator.setup_model_dataset(
        config_name=os.environ.get("STLPOSE_MODEL_CONFIG", "w32_256x192"),
        pretrained=os.environ.get("STLPOSE_PRETRAINED", "default"))
    stats = evaluator.evaluate_model()
    print_(f"AP: {stats[0]:.4f}")
    return stats


if __name__ == "__main__":
    main()
