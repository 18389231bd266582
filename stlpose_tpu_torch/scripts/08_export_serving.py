#!/usr/bin/env python
"""Serving export CLI.

    python stlpose_tpu_torch/scripts/08_export_serving.py -d EXP
        [--checkpoint X] [--out DIR] [--device cuda|cpu] [--flip_tta]
        [--quant int8|int8u --calib_images DIR_OR_NPY]
        [--pipeline pose|detector|two_stage ...]

Counterpart of ``scripts/08_export_serving.py``, with ``--device`` in
place of ``--platforms``: the program is traced on that device, and its
weights live there (``load_pose_server(dir, device=...)`` moves it to the
other one). Loads the experiment's HRNet (seeded from the experiment,
then the published ``.pth`` through ``STLPOSE_PRETRAINED`` as for
``03_evaluate.py``, then ``--checkpoint``), and writes
``<out>/model.pt2`` and ``manifest.json`` with
``stlpose_tpu_torch/serving/export.py``. ``--pipeline detector`` and
``two_stage`` restore the detector (``STLPOSE_DETECTOR_CONFIG``,
``--detector_checkpoint``) into the live template; the trunk flavor comes
from ``--trunk_quant`` alone, and ``STLPOSE_PALLAS_ROI_INT8=1`` asks for
the int8 RoI pyramid, as for ``03_evaluate_faster_rcnn.py``. The pose
artifact has a symbolic batch; detector and two-stage artifacts take
``--batch``. ``STLPOSE_MODEL_CONFIG`` names the HRNet config.
"""

import argparse
import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from stlpose_tpu_torch.config import CONFIG, get_hrnet_config  # noqa: E402
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet  # noqa: E402
from stlpose_tpu_torch.serving.export import (  # noqa: E402
    export_detector_server, export_pose_server, export_two_stage_server)
from stlpose_tpu_torch.train.state import create_train_state  # noqa: E402
from stlpose_tpu_torch.utils.arguments import resolve_exp_path  # noqa: E402
from stlpose_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, load_detector_checkpoint, load_pretrained_variables)
from stlpose_tpu_torch.utils.experiment import \
    load_experiment_parameters  # noqa: E402


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--exp_directory", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="experiment checkpoint name to export")
    ap.add_argument("--out", default=None,
                    help="output dir (default <exp>/serving_export)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the program is traced on and its "
                         "weights live on (cuda unless cpu is asked for)")
    ap.add_argument("--pipeline", default="pose",
                    choices=["pose", "two_stage", "detector"],
                    help="two_stage additionally loads the experiment's "
                         "detector (STLPOSE_DETECTOR_CONFIG / "
                         "--detector_checkpoint) and exports the fused "
                         "detector->crops->pose program; detector exports "
                         "the detector stage alone (boxes/scores/labels/"
                         "valid), with optional --trunk_quant flavors")
    ap.add_argument("--detector_checkpoint", default=None)
    ap.add_argument("--batch", type=int, default=8,
                    help="static batch of a two_stage or detector export")
    ap.add_argument("--max_dets", type=int, default=16)
    ap.add_argument("--bbox_thr", type=float, default=0.5)
    ap.add_argument("--crop_budget", type=int, default=None)
    ap.add_argument("--image_dtype", default="float32",
                    choices=["float32", "uint8"],
                    help="detector / two_stage image ingest: uint8 ships "
                         "0-255 bytes (4x cheaper wire) and converts on "
                         "the device")
    ap.add_argument("--packed", action="store_true",
                    help="two_stage: pack all outputs into ONE flat f32 "
                         "buffer (one device-to-host copy a call; layout "
                         "in the manifest)")
    ap.add_argument("--flip_tta", action="store_true",
                    help="pose: the eval-grade flip-TTA program "
                         "(doubled-batch forward + flip-back averaging)")
    ap.add_argument("--quant", default="none", nargs="?", const="int8u",
                    choices=["none", "int8", "int8u"],
                    help="pose: int8u (the default when --quant is given "
                         "bare) is the shifted-unsigned w8a8 accuracy "
                         "flavor; int8 the signed throughput flavor, whose "
                         "AP collapses on the JAX package's accuracy "
                         "instrument (caveat recorded in the manifest); "
                         "needs --calib_images")
    ap.add_argument("--trunk_quant", default="none", nargs="?",
                    const="int8",
                    choices=["none", "folded", "int8", "int8u"],
                    help="detector (faster_rcnn): ResNet-trunk serving "
                         "flavor; folded folds BatchNorm into the convs, "
                         "int8 (the default when given bare) / int8u also "
                         "quantize the bottlenecks and need --calib_images")
    ap.add_argument("--calib_images", default=None,
                    help="directory of images (or a .npy of uint8 "
                         "(N,H,W,3) crops) used to calibrate int8 "
                         "activation scales; images are resized to the "
                         "model input size")
    ap.add_argument("--calib_count", type=int, default=32,
                    help="max calibration images read from --calib_images")
    return ap


def pose_weights(exp_path, exp_data, config_name, checkpoint, device):
    """The experiment's HRNet weights (live BatchNorm): seeded from the
    experiment, then the published ``.pth`` (``STLPOSE_PRETRAINED``), then
    ``checkpoint``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(CONFIG["random_seed"])
        model = PoseHighResolutionNet(get_hrnet_config(config_name), device)
    pretrained = os.environ.get("STLPOSE_PRETRAINED", "default")
    if pretrained == "default":
        pretrained = os.path.join(CONFIG["paths"]["pretrained_path"],
                                  "HRnet", "pose_hrnet_w32_256x192.pth")
    load_pretrained_variables(model, pretrained)
    if checkpoint is not None:
        load_checkpoint(create_train_state(model, exp_data), exp_path,
                        checkpoint, only_model=True)
    return model.state_dict()


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    exp_path = resolve_exp_path(args.exp_directory)
    exp_data = load_experiment_parameters(exp_path)
    config_name = os.environ.get("STLPOSE_MODEL_CONFIG", "w32_256x192")
    out_dir = args.out or os.path.join(exp_path, "serving_export")
    hw = (256, 192)
    variables = pose_weights(exp_path, exp_data, config_name,
                             args.checkpoint, args.device)

    def restored_detector_and_calib():
        """Shared by the detector and two_stage pipelines: the detector
        checkpoint restored through the live-BatchNorm template (the
        checkpoints' form; the serving flavor comes from --trunk_quant
        alone), and the calibration images read once."""
        from stlpose_tpu_torch.engines.detector_trainer import \
            live_template_detector
        from stlpose_tpu_torch.models.efficientdet import EfficientDet

        detector, det_cfg = live_template_detector(
            exp_data, os.environ.get("STLPOSE_DETECTOR_CONFIG") or None,
            args.device)
        if args.detector_checkpoint is not None:
            load_detector_checkpoint(detector, exp_path,
                                     args.detector_checkpoint)
        family = ("efficientdet" if isinstance(detector, EfficientDet)
                  else "faster_rcnn")
        calib = None
        if args.trunk_quant in ("int8", "int8u"):
            if args.calib_images is None:
                ap.error(f"--trunk_quant {args.trunk_quant} requires "
                         "--calib_images")
            S = det_cfg.image_size
            # the detector's predict convention: 0-1 floats
            calib = [_load_calib_crops(args.calib_images, (S, S),
                                       args.calib_count)
                     .astype("float32") / 255.0]
        return detector, det_cfg, family, calib

    roi_patch_quant = (os.environ.get("STLPOSE_PALLAS_ROI_INT8")
                       or "0") != "0"
    if args.pipeline == "detector":
        detector, det_cfg, family, calib = restored_detector_and_calib()
        export_detector_server(
            detector, out_dir, family=family, config=det_cfg,
            device=args.device, static_batch=args.batch,
            image_dtype=args.image_dtype, trunk_quant=args.trunk_quant,
            roi_patch_quant=roi_patch_quant and family == "faster_rcnn",
            calib_batches=calib)
    elif args.pipeline == "two_stage":
        detector, det_cfg, family, calib = restored_detector_and_calib()
        export_two_stage_server(
            detector, variables, out_dir, family=family,
            det_config=det_cfg, pose_config_name=config_name,
            bbox_thr=args.bbox_thr, max_dets=args.max_dets,
            crop_budget=args.crop_budget, static_batch=args.batch,
            device=args.device, image_dtype=args.image_dtype,
            packed_output=args.packed, trunk_quant=args.trunk_quant,
            roi_patch_quant=roi_patch_quant and family == "faster_rcnn",
            calib_batches=calib)
    else:
        calib = None
        if args.quant in ("int8", "int8u"):
            if args.calib_images is None:
                ap.error(f"--quant {args.quant} requires --calib_images")
            calib = _load_calib_crops(args.calib_images, hw,
                                      args.calib_count)
        export_pose_server(variables, out_dir, config_name=config_name,
                           input_hw=hw, device=args.device,
                           flip_tta=args.flip_tta, quant=args.quant,
                           calib_crops=calib)
    print(f"exported serving artifact -> {out_dir}")
    return out_dir


def _load_calib_crops(path, input_hw, count):
    """uint8 (N, H, W, 3) calibration crops from a .npy dump or an image
    directory (resized with the host pipeline's cv2 interpolation)."""
    import numpy as np

    H, W = input_hw
    if path.endswith(".npy"):
        crops = np.load(path)[:count]
        if crops.shape[1:] != (H, W, 3):
            raise ValueError(f"calib crops {crops.shape[1:]} != {(H, W, 3)}")
        return crops.astype(np.uint8)
    import cv2
    names = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))[:count]
    if not names:
        raise ValueError(f"no images in {path}")
    crops = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(path, f)),
                                     cv2.COLOR_BGR2RGB), (W, H),
                        interpolation=cv2.INTER_LINEAR) for f in names]
    return np.stack(crops).astype(np.uint8)


if __name__ == "__main__":
    main()
