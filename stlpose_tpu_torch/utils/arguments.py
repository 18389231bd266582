"""Command-line arguments of the numbered scripts.

Port of ``stlpose_tpu/utils/arguments.py``, the same vocabulary and
checks: ``01_create_experiment`` takes the dataset, model, training and
evaluation groups (the flat ``inline_style_*`` flags folded into one
``inline_style`` parameter); the later scripts take ``-d/--exp_directory``
with the checkpoint, resume and dataset overrides, and check that the
experiment and the checkpoint exist. The port adds ``--device`` ("cuda"
unless the caller asks for the CPU), its rule for entry points.
"""

from __future__ import annotations

import argparse
import os

from stlpose_tpu_torch.config import CONFIG

_INLINE_STYLE_FLAGS = ("inline_style_dir", "inline_style_decoder_ckpt",
                       "inline_style_vgg_weights", "inline_style_alpha",
                       "inline_style_apply_to_valid")


def _bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def process_create_experiment_arguments(argv=None):
    """Arguments of 01_create_experiment; None for every group parameter
    not given, so the experiment keeps its default."""
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--exp_directory", required=True,
                   help="directory under the experiments root")
    # dataset group
    p.add_argument("--dataset_name",
                   choices=["coco", "styled_coco", "arch_data", "combined"])
    p.add_argument("--image_size", type=int)
    p.add_argument("--alpha", type=str)
    p.add_argument("--styles", type=str)
    p.add_argument("--flip", type=_bool)
    p.add_argument("--num_joints_half_body", type=int)
    p.add_argument("--prob_half_body", type=float)
    p.add_argument("--rot_factor", type=float)
    p.add_argument("--scale_factor", type=float)
    p.add_argument("--train_set", type=str)
    p.add_argument("--test_set", type=str)
    p.add_argument("--shuffle_train", type=_bool)
    p.add_argument("--shuffle_test", type=_bool)
    # model group
    p.add_argument("--model_name", choices=["HRNet"])
    p.add_argument("--detector_name", choices=["faster_rcnn", "efficientdet"])
    p.add_argument("--detector_type", type=str)
    # training group
    p.add_argument("--num_epochs", type=int)
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--learning_rate_factor", type=float)
    p.add_argument("--patience", type=int)
    p.add_argument("--scheduler", choices=["plateau", "step", "none"])
    p.add_argument("--batch_size", type=int)
    p.add_argument("--save_frequency", type=int)
    p.add_argument("--log_frequency", type=int)
    p.add_argument("--optimizer", choices=["adam", "sgd"])
    p.add_argument("--momentum", type=float)
    p.add_argument("--nesterov", type=_bool)
    p.add_argument("--lambda_D", type=float)
    p.add_argument("--lambda_P", type=float)
    p.add_argument("--perceptual_loss", type=_bool)
    p.add_argument("--perceptual_weight", type=str)
    # evaluation group
    p.add_argument("--bbox_thr", type=float)
    p.add_argument("--det_nms_thr", type=float)
    p.add_argument("--img_thr", type=float)
    p.add_argument("--in_vis_thr", type=float)
    p.add_argument("--nms_thr", type=float)
    p.add_argument("--oks_thr", type=float)
    p.add_argument("--use_gt_bbox", type=_bool)
    # inline AdaIN stylization of the train crops (dataset.inline_style)
    p.add_argument("--inline_style_dir", type=str,
                   help="style-exemplar directory; enables the inline "
                        "AdaIN stylizer in the train pipeline")
    p.add_argument("--inline_style_decoder_ckpt", type=str,
                   help="npz from aux_train_adain_decoder.py")
    p.add_argument("--inline_style_vgg_weights", type=str)
    p.add_argument("--inline_style_alpha", type=float)
    p.add_argument("--inline_style_apply_to_valid", type=_bool)
    args = p.parse_args(argv)

    # the flat inline_style_* flags become the one dataset parameter the
    # engines read
    if args.inline_style_dir:
        args.inline_style = {
            "style_dir": args.inline_style_dir,
            "decoder_ckpt": args.inline_style_decoder_ckpt,
            "vgg_weights": args.inline_style_vgg_weights,
            "alpha": (args.inline_style_alpha
                      if args.inline_style_alpha is not None else 1.0),
            "apply_to_valid": bool(args.inline_style_apply_to_valid),
        }
    for k in _INLINE_STYLE_FLAGS:
        delattr(args, k)

    if args.batch_size is not None and args.batch_size < 1:
        p.error("batch_size must be >= 1")
    if args.learning_rate is not None and args.learning_rate <= 0:
        p.error("learning_rate must be positive")
    if args.num_epochs is not None and args.num_epochs < 1:
        p.error("num_epochs must be >= 1")
    return args


def get_directory_argument(argv=None, get_checkpoint=False,
                           get_dataset=False):
    """``-d/--exp_directory`` with the checkpoint, resume, dataset and
    device flags; the experiment (and, with ``get_checkpoint``, the
    checkpoint: the port's ``.pt`` file, pose or detector) must exist.
    Returns (experiment path, arguments)."""
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--exp_directory", required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume_training", type=_bool, default=False)
    p.add_argument("--use_perceptual_loss", type=_bool, default=False)
    p.add_argument("--save", type=_bool, default=False)
    p.add_argument("--flip", type=_bool, default=True)
    if get_dataset:
        p.add_argument("--dataset_name", type=str, default=None)
        p.add_argument("--alpha", type=str, default=None)
        p.add_argument("--styles", type=str, default=None)
    p.add_argument("--data_path", type=str, default=None,
                   help="override CONFIG data path (tests/CI)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (cuda unless cpu is "
                        "asked for)")
    args = p.parse_args(argv)

    exp_path = resolve_exp_path(args.exp_directory)
    if not os.path.exists(exp_path):
        p.error(f"Experiment directory '{exp_path}' does not exist")
    if not os.path.exists(os.path.join(exp_path,
                                       "experiment_parameters.json")):
        p.error(f"'{exp_path}' has no experiment_parameters.json")
    if args.checkpoint is not None and get_checkpoint:
        from stlpose_tpu_torch.utils.checkpoint import checkpoint_path
        ck = checkpoint_path(exp_path, args.checkpoint)
        ck_det = checkpoint_path(exp_path, args.checkpoint, detector=True)
        if not (os.path.exists(ck + ".pt") or os.path.exists(ck_det + ".pt")):
            p.error(f"Checkpoint '{ck}' does not exist (neither pose nor "
                    f"detector)")
    return exp_path, args


def model_dtype():
    """The scripts' compute dtype, from the reference's environment:
    ``STLPOSE_DTYPE=bfloat16`` gives bf16, anything else f32."""
    import torch

    return (torch.bfloat16 if os.environ.get("STLPOSE_DTYPE") == "bfloat16"
            else torch.float32)


def resolve_exp_path(exp_directory: str) -> str:
    """An absolute path, a path under the experiments root, or a bare
    experiment directory name (its newest ``experiment_*``)."""
    if os.path.isabs(exp_directory) and os.path.exists(exp_directory):
        return exp_directory
    root = CONFIG["paths"]["experiments_path"]
    candidate = os.path.join(root, exp_directory)
    if os.path.exists(os.path.join(candidate, "experiment_parameters.json")):
        return candidate
    if os.path.isdir(candidate):
        subs = sorted(d for d in os.listdir(candidate)
                      if d.startswith("experiment_"))
        if subs:
            return os.path.join(candidate, subs[-1])
    return exp_directory
