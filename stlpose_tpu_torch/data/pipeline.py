"""Host -> device input pipeline, device-warp mode.

Port of the device-warp path of ``stlpose_tpu/data/pipeline.py``. The host
decodes each image onto a fixed square letterbox canvas (uint8: resizing
a uint8 image gives uint8, so shipping bytes is exact and moves 4x less
than f32) and draws the augmentation; centres, scales and joints travel
in canvas coordinates. On the device, one finalize makes the batch: the
rotated affine crop warp, the joint transform, ImageNet normalisation and
the Gaussian targets.

The crop warp follows the TPU package's gate: the two-pass filter (K4,
``ops.warp.affine_warp_two_pass``) whenever the canvas side is a multiple
of 128 (the default canvas is 640), direct bilinear sampling (K2,
``ops.warp.affine_warp``) otherwise, on any device. The host-warp path
(``process_sample`` with ``cv2.warpAffine``) is not ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Iterator, List, Sequence

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from stlpose_tpu_torch.data.pose_dataset import (HEATMAP_SIZE, IMAGE_SIZE,
                                                 AugmentationParams,
                                                 PoseRecord, flip_perm,
                                                 read_image)
from stlpose_tpu_torch.ops.affine import apply_affine, get_affine_matrix
from stlpose_tpu_torch.ops.heatmap import generate_targets
from stlpose_tpu_torch.ops.warp import affine_warp, affine_warp_two_pass


def device_warp_finalize(canvases, centers, scales, rots, joints, vis,
                         may_rotate: bool = True):
    """The batch on the device: uint8 canvases (N, S, S, 3) and canvas-
    space centres, scales, rotations, joints and visibility -> normalised
    crops (N, 256, 192, 3), targets (N, J, 64, 48), target weights (N, J)
    and crop-space joints (N, J, 2). K4 when S % 128 == 0, else K2."""
    if canvases.shape[1] % 128 == 0:
        crops = affine_warp_two_pass(canvases, centers, scales, rots,
                                     IMAGE_SIZE, may_rotate=may_rotate)
    else:
        crops = affine_warp(canvases.to(torch.float32), centers, scales,
                            rots, IMAGE_SIZE)
    dev = crops.device
    x = ((crops / 255.0 - torch.as_tensor(IMAGENET_MEAN, device=dev)) /
         torch.as_tensor(IMAGENET_STD, device=dev))
    mats = get_affine_matrix(centers, scales, rots, IMAGE_SIZE)
    joints_crop = apply_affine(joints, mats)
    joints_crop = torch.where(vis[..., None] > 0, joints_crop, joints)
    target, weight = generate_targets(joints_crop, vis,
                                      heatmap_size=HEATMAP_SIZE,
                                      image_size=IMAGE_SIZE)
    return x, target, weight, joints_crop


class PoseDataPipeline:
    """Iterable over device-ready batches of pose crops (device warp).

    Args:
      records: list of PoseRecord.
      batch_size: batch size.
      is_train: enables augmentation (with ``exp_data``).
      exp_data: experiment params; augmentation knobs are read from
        ``exp_data["dataset"]``.
      shuffle: shuffle each epoch.
      num_workers: host decode threads.
      pad_multiple: pad the last batch to a multiple with repeated
        samples; "n_valid" marks the real entries.
      drop_last: drop the last partial batch.
      canvas_size: side of the square letterbox canvas.
      device: where the batch is made ("cuda" unless told otherwise).
    """

    def __init__(self, records: Sequence[PoseRecord], batch_size: int,
                 is_train: bool, exp_data: dict | None = None,
                 shuffle: bool = False, num_workers: int = 8,
                 pad_multiple: int = 1, drop_last: bool = False,
                 seed: int = 13, canvas_size: int = 640, device="cuda"):
        self.records = list(records)
        self.batch_size = batch_size
        self.is_train = is_train
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.pad_multiple = pad_multiple
        self.drop_last = drop_last
        self.canvas_size = canvas_size
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        self.aug = None
        if is_train and exp_data is not None:
            d = exp_data["dataset"]
            self.aug = AugmentationParams(
                scale_factor=d.get("scale_factor", 0.0),
                rotation_factor=d.get("rot_factor", 0.0),
                flip=d.get("flip", False),
                num_joints_half_body=d.get("num_joints_half_body", 8),
                prob_half_body=d.get("prob_half_body", 0.0),
                seed=seed)
        self._aug_lock = threading.Lock()

    def __len__(self):
        n = len(self.records)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_one_raw(self, rec: PoseRecord):
        """Host stage: decode, then ``_letterbox``."""
        return self._letterbox(read_image(rec.image), rec)

    def _letterbox(self, img: np.ndarray, rec: PoseRecord):
        """Augmentation draw (and mirror) of a decoded RGB uint8 image, then
        its letterbox canvas; geometry scaled to canvas coordinates. An
        image whose letterbox size is its own size is copied as it is
        (what a resize to the same size gives), so such images need no
        cv2."""
        joints = rec.joints.copy()
        vis = rec.joints_vis.copy()
        c, s, r = rec.center.copy(), rec.scale.copy(), 0.0
        if self.aug is not None:
            with self._aug_lock:
                c, s, r, do_flip = self.aug.sample(c, s, joints, vis)
            if do_flip:
                img = img[:, ::-1, :]
                perm = flip_perm(len(joints))
                joints[:, 0] = img.shape[1] - joints[:, 0] - 1
                joints = joints[perm] * vis[perm][:, None]
                vis = vis[perm]
                c[0] = img.shape[1] - c[0] - 1

        S = self.canvas_size
        lam = min(S / img.shape[0], S / img.shape[1])
        nh, nw = int(round(img.shape[0] * lam)), int(round(img.shape[1] * lam))
        canvas = np.zeros((S, S, 3), np.uint8)
        if (nh, nw) == img.shape[:2]:
            canvas[:nh, :nw] = img
        else:
            import cv2
            canvas[:nh, :nw] = cv2.resize(img, (nw, nh),
                                          interpolation=cv2.INTER_LINEAR)
        meta = {"center": c.astype(np.float32), "scale": s.astype(np.float32),
                "rotation": np.float32(r), "score": np.float32(rec.score),
                "image_id": np.int64(rec.image_id),
                "perceptual_loss": np.float32(rec.perceptual_loss)}
        return (canvas, (c * lam).astype(np.float32),
                (s * lam).astype(np.float32), np.float32(r),
                (joints * lam).astype(np.float32), vis.astype(np.float32),
                meta)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                samples = list(pool.map(
                    lambda i: self._load_one_raw(self.records[i]), idx))
                yield self._collate_device_warp(
                    samples, [self.records[i] for i in idx])

    def _collate_device_warp(self, samples: List, recs: List[PoseRecord]
                             ) -> dict:
        """Stack the host samples, move them to the device and finalize.
        ``joints`` (crop space) stays on the device; the metadata stays on
        the host, in original image coordinates."""
        canvases = np.stack([s[0] for s in samples])
        centers = np.stack([s[1] for s in samples])
        scales = np.stack([s[2] for s in samples])
        rots = np.asarray([s[3] for s in samples], np.float32)
        joints = np.stack([s[4] for s in samples])
        vis = np.stack([s[5] for s in samples])
        metas = [s[6] for s in samples]
        n_valid = len(samples)

        pad = (-n_valid) % self.pad_multiple if self.pad_multiple > 1 else 0
        if pad:
            sel = np.arange(pad) % n_valid
            canvases = np.concatenate([canvases, canvases[sel]])
            centers = np.concatenate([centers, centers[sel]])
            scales = np.concatenate([scales, scales[sel]])
            rots = np.concatenate([rots, rots[sel]])
            joints = np.concatenate([joints, joints[sel]])
            vis = np.concatenate([vis, vis[sel]])
            metas = metas + [metas[i] for i in sel]

        dev = self.device
        x, target, weight, joints_crop = device_warp_finalize(
            *(torch.from_numpy(a).to(dev) for a in
              (canvases, centers, scales, rots, joints, vis)),
            # no augmentation: rot is 0, the conditioning test is skipped
            may_rotate=self.aug is not None)
        return {
            "image": x, "target": target, "target_weight": weight,
            "joints": joints_crop, "joints_vis": vis,
            "center": np.stack([m["center"] for m in metas]),
            "scale": np.stack([m["scale"] for m in metas]),
            "score": np.array([m["score"] for m in metas], np.float32),
            "image_id": np.array([m["image_id"] for m in metas], np.int64),
            "perceptual_loss": np.array(
                [m["perceptual_loss"] for m in metas], np.float32),
            "n_valid": n_valid,
        }
