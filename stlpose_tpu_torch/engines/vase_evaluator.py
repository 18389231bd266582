"""Fused two-stage detect -> pose serving program.

Port of ``stlpose_tpu/engines/vase_evaluator.py`` (``_fused_pack_spec``,
``_pack_fused_outputs``, ``_unpack_fused_outputs``,
``build_fused_two_stage``): detector predict -> on-device class/score/
top-``max_dets`` filter -> cross-batch crop compaction -> affine crops
(K2) -> HRNet -> per-crop and full-image decode (K1). The detector's
RoIAlign is K3.

The program takes its flavor from its models: a bf16 detector returns
bf16 scores, and the score filter and the compaction key then run in bf16
as in the JAX package's bf16 program (the key rounds to bf16, so its ties
are broken by the stable top-k); crops and their normalisation stay f32,
HRNet casts its input to its own dtype and returns f32 heatmaps for K1.
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from stlpose_tpu_torch.kernels import decode as _k1
from stlpose_tpu_torch.ops.affine import coords_to_center_scale, \
    transform_preds
from stlpose_tpu_torch.ops.nms import top_k
from stlpose_tpu_torch.ops.warp import crop_from_center_scale_batched

CROP_W, CROP_H = 192, 256


def _fused_pack_spec(B: int, m: int, budget: int, J: int = 17):
    """Static (key, shape, dtype) layout of the fused outputs when
    flattened into one f32 buffer (one device-to-host copy per call)."""
    return (("sel_boxes", (B, m, 4), np.float32),
            ("sel_scores", (B, m), np.float32),
            ("sel_valid", (B, m), np.bool_),
            ("img_idx", (budget,), np.int32),
            ("picked_valid", (budget,), np.bool_),
            ("crop_kpts", (budget, J, 3), np.float32),
            ("img_kpts", (budget, J, 3), np.float32))


def _pack_fused_outputs(out, spec):
    """Flatten + cast every output to f32 and concatenate (bool -> {0,1};
    int32 image indices are exact in f32)."""
    return torch.cat([out[k].to(torch.float32).reshape(-1)
                      for k, _, _ in spec])


def _unpack_fused_outputs(buf: np.ndarray, spec):
    """Host inverse of :func:`_pack_fused_outputs`; a layout mismatch
    fails loudly instead of mis-splitting."""
    total = sum(int(np.prod(shape)) for _, shape, _ in spec)
    if buf.size != total:
        raise ValueError(
            f"packed buffer has {buf.size} elements but the spec "
            f"describes {total} — pack/spec layout mismatch")
    out, off = {}, 0
    for k, shape, dt in spec:
        n = int(np.prod(shape))
        v = buf[off:off + n].reshape(shape)
        off += n
        if dt == np.bool_:
            v = v > 0.5
        elif dt == np.int32:
            v = np.rint(v).astype(np.int32)
        out[k] = v
    return out


def build_fused_two_stage(detector, pose_model, *, bbox_thr: float,
                          max_dets: int, budget: int, device="cuda"):
    """The whole two-stage pass as one function ``fused(images) -> dict``.

    ``detector`` is a ``models.faster_rcnn.FasterRCNN`` and ``pose_model``
    a ``models.hrnet.PoseHighResolutionNet``, both on ``device``, in any
    of their flavors. ``images`` is (B, S, S, 3), uint8 0-255 or float in
    [0, 1]; it is moved to ``device``. Outputs: sel_boxes (B, m, 4),
    sel_scores (B, m) in the detector's dtype, sel_valid (B, m), img_idx
    (budget,), picked_valid (budget,), crop_kpts / img_kpts (budget, J, 3)
    as (x, y, score)."""
    device = resolve_device(device)
    for name, mod in (("detector", detector), ("pose_model", pose_model)):
        dev = next(mod.parameters()).device
        if dev.type != device.type:
            raise ValueError(f"{name} is on {dev}, the program on {device}")
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    @torch.inference_mode()
    def fused(images):
        images = torch.as_tensor(images, device=device)
        # uint8 ingest: clients ship 0-255 bytes, [0, 1] is made here
        if images.dtype == torch.uint8:
            images01 = images.to(torch.float32) / 255.0
        else:
            images01 = images.to(torch.float32)
        dets = detector.predict(images01)
        boxes, scores = dets["boxes"], dets["scores"]
        keep = dets["valid"] & (dets["labels"] == 1) & (scores >= bbox_thr)
        masked = torch.where(keep, scores, -torch.inf)
        m = min(max_dets, masked.shape[1])
        top_s, top_i = top_k(masked, m)                            # (B, m)
        sel_boxes = torch.gather(boxes, 1,
                                 top_i[..., None].expand(-1, -1, 4))
        sel_valid = top_s > -torch.inf
        # cross-batch compaction: key = valid-first, then score (scores
        # lie in (0, 1), so within one image the order is its score order);
        # summed in the scores' dtype
        key_flat = ((sel_valid.reshape(-1) * 10.0).to(top_s.dtype) +
                    torch.where(sel_valid, top_s, 0.0).reshape(-1))
        _, idx = top_k(key_flat, budget)
        img_idx = (idx // m).to(torch.int32)
        flat_boxes = sel_boxes.reshape(-1, 4)[idx]
        picked_valid = sel_valid.reshape(-1)[idx]
        # invalid slots get a unit box: their crops are discarded, but a
        # degenerate box must not feed non-finite math to the warp
        flat_boxes = torch.where(
            picked_valid[:, None], flat_boxes,
            torch.tensor([0.0, 0.0, 32.0, 32.0], device=device))
        centers, scales = coords_to_center_scale(flat_boxes,
                                                 CROP_W / CROP_H)
        crops = crop_from_center_scale_batched(
            images01 * 255.0, centers, scales, img_idx, (CROP_W, CROP_H))
        x = (crops / 255.0 - mean) / std
        hm = pose_model(x).permute(0, 3, 1, 2)                # (K, J, H, W)
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

    return fused
