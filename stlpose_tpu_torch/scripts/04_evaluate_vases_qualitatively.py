#!/usr/bin/env python
"""Two-stage detect -> pose qualitative evaluation on unannotated vase
images.

    python stlpose_tpu_torch/scripts/04_evaluate_vases_qualitatively.py
        -d EXP [--checkpoint N|final] [--detector_checkpoint N|final]
        [--dataset_name ccoimages_final] [--bbox_thr 0.5] [--kpt_thr 0.1]
        [--data_path DIR] [--limit N] [--device cuda|cpu]

Counterpart of ``scripts/04_evaluate_vases_qualitatively.py``:
``VaseEvaluator`` over the images of ``<data>/<dataset_name>``, one at a
time, each image's detections and skeletons drawn under
``plots/vases_<dataset_name>`` (matplotlib; the JPEG decode needs
cv2). The environment is the
reference's: ``STLPOSE_DETECTOR_CONFIG`` (faster_rcnn,
faster_rcnn_tiny, faster_rcnn_torchvision_parity),
``STLPOSE_MODEL_CONFIG`` (default w32_256x192), ``STLPOSE_PRETRAINED`` (a
reference-format HRNet ``.pth``; empty for none), ``STLPOSE_DTYPE=
bfloat16``, ``STLPOSE_FRCNN_TRUNK_QUANT=folded``,
``STLPOSE_PALLAS_ROI_INT8=1`` and the ``STLPOSE_*_PATH`` directories;
they reach the engine as arguments.
"""

import argparse
import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator  # noqa: E402
from stlpose_tpu_torch.utils.arguments import (model_dtype,  # noqa: E402
                                               resolve_exp_path)
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None) -> VaseEvaluator:
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--exp_directory", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--detector_checkpoint", default=None)
    p.add_argument("--dataset_name", default="ccoimages_final",
                   help="image directory under the data root "
                        "(ccoimages_final / red_black / open_subset)")
    p.add_argument("--bbox_thr", type=float, default=0.5)
    p.add_argument("--kpt_thr", type=float, default=0.1)
    p.add_argument("--data_path", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda unless cpu is "
                        "asked for)")
    args = p.parse_args(argv)

    exp_path = resolve_exp_path(args.exp_directory)
    Logger(exp_path)
    print_("Two-stage qualitative vase evaluation", type="new_exp")
    ev = VaseEvaluator(
        exp_path, checkpoint=args.checkpoint,
        detector_checkpoint=args.detector_checkpoint,
        dataset_name=args.dataset_name, data_path=args.data_path,
        bbox_thr=args.bbox_thr, kpt_thr=args.kpt_thr,
        detector_config=os.environ.get("STLPOSE_DETECTOR_CONFIG") or None,
        dtype=model_dtype(),
        trunk_quant=os.environ.get("STLPOSE_FRCNN_TRUNK_QUANT") or "none",
        roi_patch_quant=(os.environ.get("STLPOSE_PALLAS_ROI_INT8")
                         or "0") != "0",
        device=args.device)
    ev.load_vase_subset()
    ev.setup_models(
        config_name=os.environ.get("STLPOSE_MODEL_CONFIG", "w32_256x192"),
        pretrained=os.environ.get("STLPOSE_PRETRAINED") or None)
    n = ev.qualitative_comparison(limit=args.limit)
    print_(f"Rendered {n} images to {ev.plots_path}")
    return ev


if __name__ == "__main__":
    main()
