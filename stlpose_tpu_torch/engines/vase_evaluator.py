"""Two-stage detect -> pose qualitative evaluation engine.

Port of ``stlpose_tpu/engines/vase_evaluator.py``: the fused serving
program (``build_fused_two_stage`` around the ``FusedTwoStage`` module;
its packed wire format ``_fused_pack_spec``, ``_pack_fused_outputs`` and
``_unpack_fused_outputs`` lives in ``serving/packing.py``, which loads
without model code) and ``VaseEvaluator``, the engine behind
``04_evaluate_vases_qualitatively.py``.

The fused program: detector predict -> on-device class/score/
top-``max_dets`` filter -> cross-batch crop compaction -> affine crops
(K2) -> HRNet -> per-crop and full-image decode (K1). The detector is
either family: Faster R-CNN (RoIAlign on K3, after K3q in the int8 patch
flavor; proposal and detection NMS on K5) or EfficientDet (detection NMS
on K5). The
program takes its flavor from its models: a bf16 detector returns bf16
scores, and the score filter and the compaction key then run in bf16 as
in the JAX package's bf16 program (the key rounds to bf16, so its ties
are broken by the stable top-k); crops and their normalisation stay f32,
HRNet casts its input to its own dtype and returns f32 heatmaps for K1.

``VaseEvaluator`` runs the fused program by default, with one
device-to-host copy of its packed outputs per call. Its host path (score
filter, ordering and crop batching on the host, the pose forward and the
decode on the device) is kept as the equality oracle, as in the JAX
package. Rendering is host matplotlib (``utils/visualization.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import (CONFIG, IMAGENET_MEAN, IMAGENET_STD,
                                      get_hrnet_config)
from stlpose_tpu_torch.data.loaders import get_vase_subset
from stlpose_tpu_torch.engines.detector_trainer import (
    apply_trunk_flavor, build_detector, live_state_dict,
    live_template_detector)
from stlpose_tpu_torch.kernels import decode as _k1
from stlpose_tpu_torch.models.convert import load_strict
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.ops.affine import coords_to_center_scale, \
    transform_preds
from stlpose_tpu_torch.ops.bbox_utils import bbox_filtering
from stlpose_tpu_torch.ops.decode import decode_heatmaps, heatmap_argmax
from stlpose_tpu_torch.ops.nms import top_k
from stlpose_tpu_torch.ops.warp import crop_from_center_scale_batched
from stlpose_tpu_torch.parallel.steps import make_infer_fn
from stlpose_tpu_torch.serving.packing import (_fused_pack_spec,
                                               _pack_fused_outputs,
                                               _unpack_fused_outputs)
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_detector_checkpoint,
                                                load_pretrained_variables)
from stlpose_tpu_torch.utils.experiment import load_experiment_parameters
from stlpose_tpu_torch.utils.visualization import draw_pose, visualize_bbox

CROP_W, CROP_H = 192, 256


class FusedTwoStage(torch.nn.Module):
    """The fused program as a module: ``forward(images) -> dict``, its
    models and constants held as submodules and buffers, so that
    ``torch.export`` can trace it (``serving/export.py``). See
    ``build_fused_two_stage`` for the arguments and outputs."""

    def __init__(self, detector, pose_model, *, bbox_thr: float,
                 max_dets: int, budget: int, device):
        super().__init__()
        self.detector = detector
        self.pose_model = pose_model
        self.bbox_thr = bbox_thr
        self.max_dets = max_dets
        self.budget = budget
        for name, value in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD),
                            ("unit_box", (0.0, 0.0, 32.0, 32.0))):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=torch.float32, device=device), persistent=False)

    def forward(self, images):
        device = self.mean.device
        images = torch.as_tensor(images, device=device)
        # uint8 ingest: clients ship 0-255 bytes, [0, 1] is made here
        if images.dtype == torch.uint8:
            images01 = images.to(torch.float32) / 255.0
        else:
            images01 = images.to(torch.float32)
        dets = self.detector.predict(images01)
        boxes, scores = dets["boxes"], dets["scores"]
        keep = (dets["valid"] & (dets["labels"] == 1) &
                (scores >= self.bbox_thr))
        masked = torch.where(keep, scores, -torch.inf)
        m = min(self.max_dets, masked.shape[1])
        top_s, top_i = top_k(masked, m)                            # (B, m)
        sel_boxes = torch.gather(boxes, 1,
                                 top_i[..., None].expand(-1, -1, 4))
        sel_valid = top_s > -torch.inf
        # cross-batch compaction: key = valid-first, then score (scores
        # lie in (0, 1), so within one image the order is its score order);
        # summed in the scores' dtype
        key_flat = ((sel_valid.reshape(-1) * 10.0).to(top_s.dtype) +
                    torch.where(sel_valid, top_s, 0.0).reshape(-1))
        _, idx = top_k(key_flat, self.budget)
        img_idx = (idx // m).to(torch.int32)
        flat_boxes = sel_boxes.reshape(-1, 4)[idx]
        picked_valid = sel_valid.reshape(-1)[idx]
        # invalid slots get a unit box: their crops are discarded, but a
        # degenerate box must not feed non-finite math to the warp
        flat_boxes = torch.where(picked_valid[:, None], flat_boxes,
                                 self.unit_box)
        centers, scales = coords_to_center_scale(flat_boxes,
                                                 CROP_W / CROP_H)
        crops = crop_from_center_scale_batched(
            images01 * 255.0, centers, scales, img_idx, (CROP_W, CROP_H))
        x = (crops / 255.0 - self.mean) / self.std
        hm = self.pose_model(x).permute(0, 3, 1, 2)           # (K, J, H, W)
        Hh, Hw = hm.shape[2], hm.shape[3]
        # one K1 launch gives both the unrefined crop-space peaks and the
        # quarter-pixel shift of the refined image-space ones
        coords, maxvals, shift = _k1.heatmap_peaks(hm)
        crop_xy = coords * torch.tensor(
            [(CROP_W - 1.0) / (Hw - 1), (CROP_H - 1.0) / (Hh - 1)],
            device=device)
        crop_kpts = torch.cat([crop_xy, maxvals[..., None]], dim=-1)
        preds = transform_preds(coords + shift, centers, scales, (Hw, Hh))
        img_kpts = torch.cat([preds, maxvals[..., None]], dim=-1)
        return {"sel_boxes": sel_boxes, "sel_scores": top_s,
                "sel_valid": sel_valid, "img_idx": img_idx,
                "picked_valid": picked_valid, "crop_kpts": crop_kpts,
                "img_kpts": img_kpts}


def build_fused_two_stage(detector, pose_model, *, bbox_thr: float,
                          max_dets: int, budget: int, device="cuda"):
    """The whole two-stage pass as one function ``fused(images) -> dict``,
    run under ``torch.inference_mode`` (``fused.module`` is the
    ``FusedTwoStage`` it calls).

    ``detector`` is a ``models.faster_rcnn.FasterRCNN`` or a
    ``models.efficientdet.EfficientDet`` and ``pose_model`` a
    ``models.hrnet.PoseHighResolutionNet``, both on ``device``, in any of
    their flavors. ``images`` is (B, S, S, 3), uint8 0-255 or float in
    [0, 1]; it is moved to ``device``. Outputs: sel_boxes (B, m, 4),
    sel_scores (B, m) in the detector's dtype, sel_valid (B, m), img_idx
    (budget,), picked_valid (budget,), crop_kpts / img_kpts (budget, J, 3)
    as (x, y, score)."""
    device = resolve_device(device)
    for name, mod in (("detector", detector), ("pose_model", pose_model)):
        dev = next(mod.parameters()).device
        if dev.type != device.type:
            raise ValueError(f"{name} is on {dev}, the program on {device}")
    module = FusedTwoStage(detector, pose_model, bbox_thr=bbox_thr,
                           max_dets=max_dets, budget=budget, device=device)

    @torch.inference_mode()
    def fused(images):
        return module(images)

    fused.module = module
    return fused


def _seeded(build):
    """``build()`` with the global generator seeded from the experiment
    seed, the caller's generator state restored after."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(CONFIG["random_seed"])
        return build()


class VaseEvaluator:
    """Engine behind 04_evaluate_vases_qualitatively.py, on ``device``
    ("cuda" unless the caller asks for the CPU).

    ``dtype`` is the compute dtype of both models (the JAX engine reads
    ``STLPOSE_DTYPE``); ``trunk_quant`` ("none", "folded", "int8" or
    "int8u"; the int8 trunks calibrate on the first batch of the vase
    subset) and ``roi_patch_quant`` are the detector's serving flavors
    (the JAX detector reads ``STLPOSE_FRCNN_TRUNK_QUANT`` and
    ``STLPOSE_PALLAS_ROI_INT8``). ``use_fused`` None or True runs the
    fused program, False the host path. ``crop_budget`` is the fused
    program's crop budget; None (or more) gives B * max_dets, so nothing
    is dropped."""

    def __init__(self, exp_path: str, checkpoint=None,
                 detector_checkpoint=None, dataset_name: str = "red_black",
                 data_path=None, bbox_thr: float = 0.5,
                 kpt_thr: float = 0.1, max_dets: int = 8,
                 detector_config=None, save: bool = True,
                 use_fused: bool | None = None,
                 crop_budget: int | None = None, dtype=torch.float32,
                 trunk_quant: str = "none", roi_patch_quant: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.exp_path = exp_path
        self.exp_data = load_experiment_parameters(exp_path)
        self.checkpoint = checkpoint
        self.detector_checkpoint = detector_checkpoint
        self.dataset_name = dataset_name
        self.data_path = data_path
        self.bbox_thr = bbox_thr
        self.kpt_thr = kpt_thr
        self.max_dets = max_dets
        self.detector_config = detector_config
        self.save = save
        self.use_fused = use_fused
        self.crop_budget = crop_budget
        self.dtype = dtype
        self.trunk_quant = trunk_quant
        self.roi_patch_quant = roi_patch_quant
        self._fused_cache = {}
        self.plots_path = os.path.join(exp_path, "plots",
                                       f"vases_{dataset_name}")

    def load_vase_subset(self, batch_size: int = 1):
        """The detector (seeded initialisation; ``setup_models`` loads its
        checkpoint) and the vase image pipeline at its canvas size."""
        self.detector, self.det_cfg = _seeded(lambda: build_detector(
            self.exp_data, self.detector_config, dtype=self.dtype,
            trunk_quant=self.trunk_quant,
            roi_patch_quant=self.roi_patch_quant, device=self.device))
        self.pipe = get_vase_subset(
            img_size=self.det_cfg.image_size,
            dataset_name=self.dataset_name, data_path=self.data_path,
            batch_size=batch_size)

    def setup_models(self, config_name: str = "w32_256x192",
                     pretrained=None):
        """The detector's weights and the pose model. A live trunk takes
        the checkpoint, if one was named; another trunk flavor is made
        from the live template (seeded weights, then the checkpoint's),
        the int8 trunks calibrating on the first batch of the vase subset.
        The pose model: HRNet in ``dtype`` with live BatchNorm, from seeded
        initialisation, then a reference-format ``pretrained`` .pth, then
        the checkpoint (weights only). ``load_vase_subset`` must have
        run."""
        tq = getattr(self.detector, "trunk_quant", "none")
        if tq == "none":
            if self.detector_checkpoint is not None:
                load_detector_checkpoint(self.detector, self.exp_path,
                                         self.detector_checkpoint)
        else:
            template, _ = live_template_detector(
                self.exp_data, self.detector_config, self.device)
            if self.detector_checkpoint is not None:
                load_detector_checkpoint(template, self.exp_path,
                                         self.detector_checkpoint)

            def calib_batch():
                pipe = getattr(self, "pipe", None)
                if pipe is None:
                    raise RuntimeError(
                        f"trunk_quant={tq!r} calibrates on the first image "
                        "batch: call load_vase_subset() before "
                        "setup_models(), or set ev.pipe = [{'image': "
                        "batch}] with a (N, S, S, 3) 0-1 float batch")
                return next(iter(pipe))["image"]

            load_strict(self.detector, apply_trunk_flavor(
                self.detector, self.det_cfg, live_state_dict(template),
                calib_batch_fn=calib_batch))
        self.pose_model = _seeded(lambda: PoseHighResolutionNet(
            get_hrnet_config(config_name), self.device, self.dtype))
        load_pretrained_variables(self.pose_model, pretrained)
        if self.checkpoint is not None:
            load_checkpoint(create_train_state(self.pose_model,
                                               self.exp_data),
                            self.exp_path, self.checkpoint, only_model=True)
        self.pose_infer = make_infer_fn(self.pose_model, flip_tta=False,
                                        decode=False)

    def process_image(self, image01):
        """The two-stage pass on ONE (S, S, 3) image (see
        ``process_images``)."""
        return self.process_images(np.asarray(image01)[None])[0]

    # ------------------------------------------------------- fused path
    def _get_fused(self, B: int, budget: int):
        """(program, pack spec) of the fused pass at a (batch, budget)
        shape: ``program(images)`` returns every output packed into one
        f32 device buffer."""
        key = (B, budget)
        if key not in self._fused_cache:
            inner = build_fused_two_stage(
                self.detector, self.pose_model, bbox_thr=self.bbox_thr,
                max_dets=self.max_dets, budget=budget, device=self.device)
            m = min(self.max_dets, self.det_cfg.detections_per_img)
            spec = _fused_pack_spec(B, m, budget,
                                    self.pose_model.config.num_joints)

            def packed(images):
                return _pack_fused_outputs(inner(images), spec)

            self._fused_cache[key] = (packed, spec)
        return self._fused_cache[key]

    def _upload(self, images01):
        """The batch on the device: uint8 (0-255) goes up as bytes and is
        converted there, anything else as f32 in [0, 1]."""
        t = images01 if isinstance(images01, torch.Tensor) else \
            torch.from_numpy(np.asarray(images01))
        if t.dtype != torch.uint8:
            t = t.to(torch.float32)
        return t.to(self.device)

    def _fused_budget(self, B: int) -> int:
        m = min(self.max_dets, self.det_cfg.detections_per_img)
        return min(self.crop_budget or B * m, B * m)

    def _unpack(self, buf, spec):
        """Host side of one fused call: one device-to-host copy of the
        packed buffer (a fresh host array each call: the outputs are
        views of it, and the ``kpt_thr`` zeroing writes through them),
        then the split per image."""
        out = _unpack_fused_outputs(buf.cpu().numpy(), spec)
        crop_kpts, img_kpts = out["crop_kpts"], out["img_kpts"]
        for arr in (crop_kpts, img_kpts):
            arr[arr[..., 2] < self.kpt_thr] = 0
        results = []
        for i in range(out["sel_valid"].shape[0]):
            v = out["sel_valid"][i]
            pick = (out["img_idx"] == i) & out["picked_valid"]
            results.append({
                "boxes": out["sel_boxes"][i][v],
                "scores": out["sel_scores"][i][v],
                "crop_keypoints": crop_kpts[pick],
                "image_keypoints": img_kpts[pick]})
        return results

    def _process_images_fused(self, images01):
        imgs = self._upload(images01)
        B = imgs.shape[0]
        fused, spec = self._get_fused(B, self._fused_budget(B))
        return self._unpack(fused(imgs), spec)

    # -------------------------------------------------------- host path
    def _process_images_host(self, images01):
        """The equality oracle: detector on the device, score filter and
        ordering (``np.argsort``) on the host, the valid crops batched to
        the next power of two (the last box repeated), pose forward on
        the device, its heatmaps to the host and back up for the per-crop
        and the full-image decode (K1)."""
        imgs = images01.cpu().numpy() if isinstance(images01, torch.Tensor) \
            else np.asarray(images01)
        imgs = (imgs.astype(np.float32) / 255.0 if imgs.dtype == np.uint8
                else imgs.astype(np.float32))
        B = imgs.shape[0]
        dev = self.device
        dets = self.detector.predict(torch.from_numpy(imgs).to(dev))
        # a bf16 detector's scores come to the host as their f32 values
        dets = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in dets.items()}

        per_image, flat_boxes, flat_idx = [], [], []
        for i in range(B):
            boxes, _, scores = bbox_filtering(
                {k: v[i] for k, v in dets.items()}, thr=self.bbox_thr)
            order = np.argsort(-scores)[:self.max_dets]
            boxes, scores = boxes[order], scores[order]
            per_image.append((boxes, scores))
            flat_boxes.append(boxes)
            flat_idx.append(np.full(len(boxes), i, np.int32))

        empty = {"boxes": np.zeros((0, 4), np.float32),
                 "scores": np.zeros((0,), np.float32),
                 "crop_keypoints": np.zeros((0, 17, 3)),
                 "image_keypoints": np.zeros((0, 17, 3))}
        K = sum(len(b) for b, _ in per_image)
        if K == 0:
            return [dict(empty, boxes=b, scores=s) for b, s in per_image]

        # the crop batch padded to the next power of two, so that the pose
        # forward meets at most log2 shapes
        budget = 1
        while budget < K:
            budget *= 2
        boxes_cat = np.concatenate(flat_boxes)
        idx_cat = np.concatenate(flat_idx)
        pad = budget - K
        boxes_cat = np.concatenate(
            [boxes_cat, np.tile(boxes_cat[-1:], (pad, 1))])
        idx_cat = np.concatenate(
            [idx_cat, np.full(pad, idx_cat[-1], np.int32)])

        centers, scales = coords_to_center_scale(
            torch.from_numpy(boxes_cat).to(dev), CROP_W / CROP_H)
        crops = crop_from_center_scale_batched(
            torch.from_numpy(imgs * 255.0).to(dev), centers, scales,
            torch.from_numpy(idx_cat).to(dev), (CROP_W, CROP_H))
        mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
        std = torch.as_tensor(IMAGENET_STD, device=dev)
        hm = self.pose_infer((crops / 255.0 - mean) / std)
        hm = hm.contiguous().cpu().to(dev)

        # per-crop decode at 256x192
        coords, maxvals = heatmap_argmax(hm)
        coords, maxvals = coords.cpu().numpy(), maxvals.cpu().numpy()
        Hh, Hw = hm.shape[2], hm.shape[3]
        coords[..., 0] *= np.float32((CROP_W - 1.0) / (Hw - 1))
        coords[..., 1] *= np.float32((CROP_H - 1.0) / (Hh - 1))
        crop_kpts = np.concatenate([coords, maxvals[..., None]], axis=-1)
        # full-image decode through the inverse crop transform
        preds, mv, _ = decode_heatmaps(hm, centers, scales)
        img_kpts = np.concatenate(
            [preds.cpu().numpy(), mv.cpu().numpy()[..., None]], axis=-1)
        # zero out sub-threshold keypoints, as for drawing
        for arr in (crop_kpts, img_kpts):
            arr[arr[..., 2] < self.kpt_thr] = 0

        results = []
        start = 0
        for boxes, scores in per_image:
            k = len(boxes)
            results.append({"boxes": boxes, "scores": scores,
                            "crop_keypoints": crop_kpts[start:start + k],
                            "image_keypoints": img_kpts[start:start + k]})
            start += k
        return results

    def process_images(self, images01, use_fused: bool | None = None):
        """The two-stage pass on a batch of (B, S, S, 3) images, float in
        [0, 1] or uint8 0-255 (uploaded as bytes, converted on the
        device), with cross-batch crop compaction: the valid detections
        of all images go through one pose forward.

        Returns a list of B dicts: boxes and scores after filtering (the
        detector's dtype as f32), and per-crop (crop space, K x J x 3) and
        full-image keypoints (x, y, score; zero below ``kpt_thr``)."""
        if use_fused is None:
            use_fused = self.use_fused is not False
        with torch.inference_mode():
            if use_fused:
                return self._process_images_fused(images01)
            return self._process_images_host(images01)

    def qualitative_comparison(self, limit: int | None = None):
        """Every batch of the vase pipeline through ``process_images``;
        with ``save``, each image's detections and poses drawn to
        ``plots/vases_<dataset>/img_XXXX_dets.png`` and ``_poses.png``.
        Returns the number of images processed (at most ``limit``)."""
        os.makedirs(self.plots_path, exist_ok=True)
        n_done = 0
        for batch in self.pipe:
            n = batch["n_valid"]
            if limit is not None:
                n = min(n, limit - n_done)
                if n <= 0:
                    return n_done
            # the whole batch, results cut to the valid count; the
            # pipeline does not pad its tail batch, so a short tail is a
            # new batch shape with its own program in ``_fused_cache``
            images = np.asarray(batch["image"])
            batch_res = self.process_images(images)[:n]
            images = images[:n]
            for i in range(n):
                img = images[i]
                res = batch_res[i]
                if self.save:
                    name = f"img_{int(batch['image_id'][i]):04d}"
                    visualize_bbox(
                        img, res["boxes"], res["scores"],
                        savepath=os.path.join(self.plots_path,
                                              f"{name}_dets.png"))
                    draw_pose(
                        img, res["image_keypoints"],
                        kpt_thr=self.kpt_thr,
                        savepath=os.path.join(self.plots_path,
                                              f"{name}_poses.png"))
                n_done += 1
        return n_done
