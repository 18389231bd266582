"""Ahead-of-time serving export (port of ``stlpose_tpu/serving/export.py``).

The complete serving computation is traced by ``torch.export`` and saved
with ``torch.export.save`` beside a JSON manifest:

  * pose: uint8 crops -> ImageNet normalisation -> bf16 HRNet with its
    BatchNorm folded into the convolutions (or the int8 / int8u w8a8
    graph with bf16 glue; optionally the flip-TTA program) -> heatmap
    decode to image-space keypoints on K1;
  * detector: either family's ``predict`` (Faster R-CNN or EfficientDet,
    in any trunk flavor) from float32 or uint8 images;
  * two-stage: the fused program of ``engines/vase_evaluator.py``
    (detector -> score filter -> crop compaction -> crops on K2 -> HRNet
    -> decode on K1), optionally with its outputs packed into one buffer.

The artifact is self-contained: it carries its weights (the folded, or
folded and quantized, state as the program's parameters and buffers), so
the loaded callables take only the data, and loading it needs only torch
and the port's kernel operators (``stlpose_tpu_torch.kernels``), no model
code. Each kernel is one ``torch.ops.stlpose.*`` node of the graph: it
runs the kernel on the card and its plain version on the CPU, so one
artifact serves on either device (``load_*(..., device=...)`` moves a
program exported on the other one). The pose and detector programs take a
symbolic batch; the two-stage program's batch is static (its compaction
budget is a shape).

Layout on disk (a directory):
  <dir>/model.pt2       the ``torch.export`` program
  <dir>/manifest.json   metadata (shapes, flavors, device, kernels, torch)
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import (EFFICIENTDET_D0, IMAGENET_MEAN,
                                      IMAGENET_STD, FasterRCNNConfig)
from stlpose_tpu_torch.kernels import _ops
from stlpose_tpu_torch.ops.decode import decode_heatmaps_nhwc
from stlpose_tpu_torch.ops.flip import average_flip_tta_nhwc
from stlpose_tpu_torch.serving.packing import (_fused_pack_spec,
                                               _pack_fused_outputs,
                                               _unpack_fused_outputs)

FORMAT = "torch.export"
PROGRAM = "model.pt2"
MANIFEST = "manifest.json"
QUANT_FLAVORS = ("int8", "int8u")

# The int8 PTQ flavors' accuracy story, surfaced at export time (manifest
# and warning) so that the signed flavor is not deployed unseen; the same
# text as the JAX package's, whose accuracy instrument it cites.
_INT8_ACCURACY_CAVEAT = {
    "int8": ("signed symmetric w8a8 (throughput flavor): AP50 collapses "
             "to 0 on the only available accuracy instrument "
             "(tests/test_int8_accuracy.py); NO positive accuracy "
             "evidence exists for this flavor — prefer 'int8u' or bf16"),
    "int8u": ("shifted-unsigned w8a8 (accuracy flavor): AP holds on the "
              "accuracy instrument at a measured -16% throughput vs the "
              "bf16+folded headline; bf16 remains the recommended "
              "serving config on this model"),
}


def _normalizers(device):
    """The ImageNet mean and std on the 0-255 scale, in f32 (the JAX
    serving function's ``mean`` and ``std``)."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device) * 255.0,
            torch.as_tensor(IMAGENET_STD, device=device) * 255.0)


def _state_dict(weights, device):
    """A state dict (or a module's) with every tensor on ``device``."""
    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    return {k: v.to(device) for k, v in weights.items()
            if not k.endswith("num_batches_tracked")}


class PoseServer(torch.nn.Module):
    """``forward(crops_u8, centers, scales) -> {"keypoints" (b, J, 2) image
    pixels, "scores" (b, J) peak values, "heatmaps" (b, J, 2) the refined
    heatmap-space peaks}`` (the reference's output names). With
    ``flip_tta`` one doubled-batch forward over the crops and their mirror
    images, the flipped-back heatmaps averaged before the decode."""

    def __init__(self, model, flip_tta: bool = False):
        super().__init__()
        self.model = model
        self.flip_tta = flip_tta
        mean, std = _normalizers(next(model.parameters()).device)
        self.register_buffer("mean", mean, persistent=False)
        self.register_buffer("std", std, persistent=False)

    def heatmaps(self, crops_u8):
        """The (b, Hh, Hw, J) f32 heatmaps that the decode reads."""
        x = (crops_u8.to(torch.float32) - self.mean) / self.std
        if not self.flip_tta:
            return self.model(x)
        n = x.shape[0]
        out = self.model(torch.cat([x, torch.flip(x, dims=[2])]))
        return average_flip_tta_nhwc(out[:n], out[n:])

    def forward(self, crops_u8, centers, scales):
        preds, maxvals, coords = decode_heatmaps_nhwc(
            self.heatmaps(crops_u8), centers, scales)
        return {"keypoints": preds, "scores": maxvals, "heatmaps": coords}


class DetectorServer(torch.nn.Module):
    """``forward(images) -> detector.predict``'s {boxes, scores, labels,
    valid}; uint8 images (0-255) are made [0, 1] floats on the device."""

    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, images):
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        return self.detector.predict(images)


class PackedTwoStage(torch.nn.Module):
    """The fused program with its outputs packed into one f32 buffer in
    the layout ``spec`` (``serving/packing.py``)."""

    def __init__(self, fused, spec):
        super().__init__()
        self.fused = fused
        self.spec = spec

    def forward(self, images):
        return _pack_fused_outputs(self.fused(images), self.spec)


def _check_image_dtype(image_dtype: str):
    if image_dtype not in ("float32", "uint8"):
        raise ValueError(f"image_dtype must be float32|uint8, got "
                         f"{image_dtype}")


def _image_input(batch, S, image_dtype):
    return [batch, S, S, 3, "uint8 (0-255 RGB, converted on device)"
            if image_dtype == "uint8" else "float32 (0-1 RGB)"]


def pose_server_model(weights, config_name: str = "w32_256x192",
                      device="cuda", fold: bool = True, quant: str = "none",
                      calib_crops=None):
    """The HRNet that a pose artifact serves, from live (unfolded) weights:
    bf16, BatchNorm folded when ``fold``; ``quant`` "int8" / "int8u"
    folds, calibrates in f32 on ``calib_crops`` (uint8 (N, H, W, 3),
    normalised as serving normalises) and quantizes (w8a8, bf16 glue)."""
    from stlpose_tpu_torch.models.convert import load_strict
    from stlpose_tpu_torch.models.hrnet import create_hrnet
    from stlpose_tpu_torch.models.quantize import (calibrate_hrnet,
                                                   fold_batchnorms,
                                                   quantize_hrnet)

    device = resolve_device(device)
    sd = _state_dict(weights, device)
    if quant in QUANT_FLAVORS:
        folded = fold_batchnorms(sd)
        mean, std = _normalizers(device)
        xc = (torch.as_tensor(calib_crops, device=device)
              .to(torch.float32) - mean) / std
        calib = load_strict(create_hrnet(config_name, device, torch.float32,
                                         folded=True, quant="calib"), folded)
        stats = calibrate_hrnet(calib, [xc])
        qsd = quantize_hrnet(folded, stats, act_scheme="signed"
                             if quant == "int8" else "unsigned")
        return load_strict(create_hrnet(config_name, device, torch.bfloat16,
                                        folded=True, quant=quant), qsd)
    if quant != "none":
        raise ValueError(f"unknown quant {quant!r}")
    return load_strict(create_hrnet(config_name, device, torch.bfloat16,
                                    folded=fold),
                       fold_batchnorms(sd) if fold else sd)


def detector_server_model(weights, family: str = "faster_rcnn", config=None,
                          device="cuda", dtype=None, trunk_quant: str = "none",
                          roi_patch_quant: bool = False, calib_batches=None):
    """The detector that a detector or two-stage artifact serves, from
    live-BatchNorm weights: Faster R-CNN in its trunk flavor (folded here;
    "int8" / "int8u" also calibrated on ``calib_batches``, image batches
    in the predict convention, and quantized) with the int8 RoI pyramid
    when ``roi_patch_quant``; or EfficientDet, which refuses both."""
    from stlpose_tpu_torch.models.convert import load_strict

    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    sd = _state_dict(weights, device)
    if family == "faster_rcnn":
        from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
        from stlpose_tpu_torch.models.quantize import flavored_state_dict

        det = FasterRCNN(config if config is not None else FasterRCNNConfig(),
                         device, dtype, roi_patch_quant, trunk_quant)
        calib = None if calib_batches is None else [
            torch.as_tensor(b, dtype=torch.float32, device=device)
            for b in calib_batches]
        return load_strict(det, flavored_state_dict(
            sd, trunk_quant, config=det.config, calib_batches=calib,
            dtype=dtype))
    if family == "efficientdet":
        if trunk_quant != "none":
            raise ValueError("trunk_quant is a faster_rcnn flavor")
        if roi_patch_quant:
            raise ValueError("roi_patch_quant is a faster_rcnn flavor")
        from stlpose_tpu_torch.models.efficientdet import EfficientDet

        det = EfficientDet(config if config is not None else EFFICIENTDET_D0,
                           device, dtype)
        return load_strict(det, sd)
    raise ValueError(f"unknown detector family: {family}")


def _export(module, args, symbolic_batch: bool = False):
    """``torch.export`` of ``module`` on ``args`` under no_grad, with one
    symbolic batch size for the first dimension of every input when
    ``symbolic_batch``; the module stays as it was."""
    dynamic = None
    if symbolic_batch:
        b = torch.export.Dim("b", min=1)
        dynamic = tuple({0: b} for _ in args)
    with torch.no_grad():
        return torch.export.export(module, tuple(args),
                                   dynamic_shapes=dynamic, strict=False)


def _save(exported, out_dir: str, manifest: dict) -> str:
    """Write the program and its manifest (with the device, the kernels
    in the graph and the torch version) to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, PROGRAM))
    manifest = {"format": FORMAT, **manifest,
                "kernels": _ops.operator_names(exported.graph),
                "torch_version": torch.__version__}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def export_pose_server(weights, out_dir: str,
                       config_name: str = "w32_256x192",
                       input_hw: tuple = (256, 192),
                       device="cuda",
                       fold: bool = True,
                       flip_tta: bool = False,
                       quant: str = "none",
                       calib_crops=None) -> str:
    """Export the pose serving program to ``out_dir``; returns the dir.

    Args:
      weights: the UNFOLDED model's state dict, or the model (e.g. from
        ``models/convert.py``); folding, and for int8 calibration and
        quantization, happen here.
      device: where the program is traced and its weights live ("cuda"
        unless the caller asks for the CPU); ``load_pose_server`` can move
        it to the other device.
      flip_tta: the eval-grade flip-TTA program.
      quant: "int8" (signed w8a8, the throughput flavor) or "int8u"
        (shifted-unsigned, the accuracy flavor); both need ``fold``, no
        flip-TTA and ``calib_crops`` (uint8 (N, H, W, 3)).
    """
    if quant in QUANT_FLAVORS:
        if not fold or flip_tta:
            raise ValueError("int8 export requires fold=True and no TTA")
        if calib_crops is None:
            raise ValueError("int8 export needs calib_crops")
        warnings.warn(f"--quant {quant}: {_INT8_ACCURACY_CAVEAT[quant]}",
                      stacklevel=2)
    device = resolve_device(device)
    model = pose_server_model(weights, config_name, device, fold, quant,
                              calib_crops)
    H, W = input_hw
    example = (torch.zeros((2, H, W, 3), dtype=torch.uint8, device=device),
               torch.ones((2, 2), dtype=torch.float32, device=device),
               torch.ones((2, 2), dtype=torch.float32, device=device))
    exported = _export(PoseServer(model, flip_tta), example,
                       symbolic_batch=True)
    return _save(exported, out_dir, {
        "pipeline": "pose",
        "config": config_name,
        "input": {"crops": ["b", H, W, 3, "uint8"],
                  "centers": ["b", 2, "float32"],
                  "scales": ["b", 2, "float32"]},
        "output": ["keypoints (b,J,2)", "scores (b,J)",
                   "heatmaps (b,J,2): refined heatmap-space peaks"],
        "device": device.type,
        "bn_folded": bool(fold),
        "flip_tta": bool(flip_tta),
        "quant": quant,
        "compute_dtype": ("int8_w8a8 (bf16 glue)" if quant in QUANT_FLAVORS
                          else "bfloat16"),
        **({"accuracy_caveat": _INT8_ACCURACY_CAVEAT[quant]}
           if quant in QUANT_FLAVORS else {}),
    })


def export_detector_server(weights, out_dir: str,
                           family: str = "faster_rcnn",
                           config=None,
                           device="cuda",
                           static_batch: int | None = None,
                           dtype=None,
                           image_dtype: str = "float32",
                           trunk_quant: str = "none",
                           roi_patch_quant: bool = False,
                           calib_batches=None) -> str:
    """Export a detector's inference program (trunk, proposals or anchors,
    NMS on K5 -> padded {boxes, scores, labels, valid}) to ``out_dir``.

    ``weights`` are the LIVE-BatchNorm weights (state dict or module);
    ``trunk_quant`` (faster_rcnn: "folded", "int8", "int8u"; the int8
    flavors need ``calib_batches``, image batches as predict sees them)
    and ``roi_patch_quant`` (the int8 RoI pyramid, K3q and K3) are applied
    here. The batch is symbolic unless ``static_batch`` is given."""
    _check_image_dtype(image_dtype)
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    det = detector_server_model(weights, family, config, device, dtype,
                                trunk_quant, roi_patch_quant, calib_batches)
    S = det.config.image_size
    n = 2 if static_batch is None else int(static_batch)
    images = torch.zeros((n, S, S, 3), device=device,
                         dtype=torch.uint8 if image_dtype == "uint8"
                         else torch.float32)
    exported = _export(DetectorServer(det), (images,),
                       symbolic_batch=static_batch is None)
    batch = "b" if static_batch is None else int(static_batch)
    return _save(exported, out_dir, {
        "pipeline": "detector",
        "family": family,
        "batch": batch,
        "trunk_quant": trunk_quant,
        "roi_patch_quant": bool(roi_patch_quant),
        "compute_dtype": str(dtype).replace("torch.", ""),
        "input": {"images": _image_input(batch, S, image_dtype)},
        "output": ["boxes (b,D,4)", "scores (b,D)", "labels (b,D)",
                   "valid (b,D)"],
        "device": device.type,
    })


def two_stage_server_model(det_weights, pose_weights,
                           family: str = "faster_rcnn", det_config=None,
                           pose_config_name: str = "w32_256x192",
                           bbox_thr: float = 0.5, max_dets: int = 16,
                           crop_budget: int | None = None,
                           static_batch: int = 8, device="cuda", dtype=None,
                           fold: bool = True, packed_output: bool = False,
                           trunk_quant: str = "none",
                           roi_patch_quant: bool = False,
                           calib_batches=None):
    """The program that a two-stage artifact serves (``FusedTwoStage``, in
    ``PackedTwoStage`` when ``packed_output``) and its budget; see
    ``export_two_stage_server`` for the arguments."""
    from stlpose_tpu_torch.config import get_hrnet_config
    from stlpose_tpu_torch.engines.vase_evaluator import FusedTwoStage
    from stlpose_tpu_torch.models.convert import load_strict
    from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
    from stlpose_tpu_torch.models.quantize import fold_batchnorms

    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    det = detector_server_model(det_weights, family, det_config, device,
                                dtype, trunk_quant, roi_patch_quant,
                                calib_batches)
    pose_sd = _state_dict(pose_weights, device)
    pose = load_strict(PoseHighResolutionNet(
        get_hrnet_config(pose_config_name), device, dtype, folded=fold),
        fold_batchnorms(pose_sd) if fold else pose_sd)
    B = int(static_batch)
    m = min(max_dets, det.config.detections_per_img)
    budget = int(crop_budget) if crop_budget else B * m
    budget = min(budget, B * m)
    program = FusedTwoStage(det, pose, bbox_thr=bbox_thr, max_dets=max_dets,
                            budget=budget, device=device)
    if packed_output:
        program = PackedTwoStage(program, _fused_pack_spec(
            B, m, budget, pose.config.num_joints))
    return program, budget


def export_two_stage_server(det_weights, pose_weights, out_dir: str,
                            family: str = "faster_rcnn",
                            det_config=None,
                            pose_config_name: str = "w32_256x192",
                            bbox_thr: float = 0.5,
                            max_dets: int = 16,
                            crop_budget: int | None = None,
                            static_batch: int = 8,
                            device="cuda",
                            dtype=None,
                            fold: bool = True,
                            image_dtype: str = "float32",
                            packed_output: bool = False,
                            trunk_quant: str = "none",
                            roi_patch_quant: bool = False,
                            calib_batches=None) -> str:
    """Export the whole two-stage program (``engines/vase_evaluator.py::
    FusedTwoStage``: detector -> score filter -> crop compaction -> crops
    -> HRNet -> per-crop and full-image decode) to ``out_dir``.

    The batch is STATIC (``static_batch``): the compaction budget is a
    shape. ``crop_budget`` defaults to ``static_batch * m`` (m = max_dets
    capped at the detector's detections per image: nothing dropped) and
    is clamped to it. ``det_weights`` are live-BatchNorm weights, flavored
    here as in ``export_detector_server``; ``pose_weights`` are unfolded
    and folded here when ``fold``; both models compute in ``dtype``.
    ``packed_output`` returns one flat f32 buffer in the layout recorded in
    the manifest (one device-to-host copy a call)."""
    _check_image_dtype(image_dtype)
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    program, budget = two_stage_server_model(
        det_weights, pose_weights, family, det_config, pose_config_name,
        bbox_thr, max_dets, crop_budget, static_batch, device, dtype, fold,
        packed_output, trunk_quant, roi_patch_quant, calib_batches)
    B = int(static_batch)
    S = (program.fused if packed_output else program).detector.config \
        .image_size
    images = torch.zeros((B, S, S, 3), device=device,
                         dtype=torch.uint8 if image_dtype == "uint8"
                         else torch.float32)
    exported = _export(program, (images,))
    return _save(exported, out_dir, {
        "pipeline": "two_stage",
        "family": family,
        "pose_config": pose_config_name,
        "batch": B,
        "max_dets": max_dets,
        "crop_budget": budget,
        "bbox_thr": bbox_thr,
        "bn_folded": bool(fold),
        "trunk_quant": trunk_quant,
        "roi_patch_quant": bool(roi_patch_quant),
        "compute_dtype": str(dtype).replace("torch.", ""),
        "input": {"images": _image_input(B, S, image_dtype)},
        "output": ([{"key": k, "shape": list(shape),
                     "dtype": np.dtype(dt).name}
                    for k, shape, dt in program.spec]
                   if packed_output else
                   ["sel_boxes (B,m,4)", "sel_scores (B,m)",
                    "sel_valid (B,m)", "img_idx (budget,)",
                    "picked_valid (budget,)", "crop_kpts (budget,J,3)",
                    "img_kpts (budget,J,3)"]),
        "packed_output": bool(packed_output),
        "device": device.type,
    })


def load_program(out_dir: str, device="cuda"):
    """(the ``ExportedProgram`` on ``device``, manifest) of an artifact;
    a program exported on another device is moved with
    ``torch.export.passes.move_to_device_pass``. ``out_dir`` may also be
    a dict {"model.pt2": bytes, "manifest.json": bytes} (an artifact read
    into memory)."""
    import io

    import torch.export.passes

    device = resolve_device(device)
    if isinstance(out_dir, dict):
        program = io.BytesIO(out_dir[PROGRAM])
        manifest = json.loads(out_dir[MANIFEST])
    else:
        program = os.path.join(out_dir, PROGRAM)
        with open(os.path.join(out_dir, MANIFEST)) as f:
            manifest = json.load(f)
    exported = torch.export.load(program)
    if manifest.get("device") != device.type:
        exported = torch.export.passes.move_to_device_pass(exported, device)
    return exported, manifest


def _direct_kernel_calls(module):
    """Point the loaded program's ``stlpose`` nodes at their
    ``kernels/_ops.py::Operator``: the same implementations, without the
    dispatcher's cost on each eager call (the saved graph is unchanged)."""
    for gm in module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        nodes = [n for n in gm.graph.nodes if n.op == "call_function"
                 and _ops.operator_of(n.target) is not None and not n.kwargs]
        for node in nodes:
            node.target = _ops.operator_of(node.target)
        if nodes:
            gm.recompile()
    return module


def load_pose_server(out_dir: str, device="cuda") -> tuple[Callable, dict]:
    """Load an exported artifact onto ``device``; returns (callable,
    manifest). For pose artifacts the callable is ``serve(crops_u8,
    centers, scales) -> {"keypoints", "scores", "heatmaps"}``, for
    detector and two-stage artifacts ``serve(images)`` (see the manifest's
    "output"). The weights are in the artifact; calls run under
    ``torch.inference_mode``; ``serve.program`` is the loaded
    ``ExportedProgram``."""
    exported, manifest = load_program(out_dir, device)
    module = _direct_kernel_calls(exported.module())

    @torch.inference_mode()
    def serve(*args):
        return module(*args)

    serve.program = exported
    return serve, manifest


def load_two_stage_server(out_dir: str, device="cuda") -> tuple[Callable,
                                                                dict]:
    """Load a two-stage artifact into ``serve(images) -> dict``. A
    ``packed_output`` artifact's buffer is fetched once to the host and
    unpacked there with the layout in the manifest (a dict of numpy
    arrays); an unpacked artifact returns its dict of tensors as it is."""
    serve, manifest = load_pose_server(out_dir, device)
    if not manifest.get("packed_output"):
        return serve, manifest
    spec = [(e["key"], tuple(e["shape"]), np.dtype(e["dtype"]))
            for e in manifest["output"]]

    def serve_unpacked(images):
        buf = serve(images).cpu().numpy()
        return _unpack_fused_outputs(buf, spec)

    serve_unpacked.program = serve.program
    return serve_unpacked, manifest
