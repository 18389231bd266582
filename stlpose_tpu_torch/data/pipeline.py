"""Host -> device input pipeline.

Port of ``stlpose_tpu/data/pipeline.py``, in its two modes.

- Device warp: the host decodes each image onto a fixed square letterbox
  canvas (uint8: resizing a uint8 image gives uint8, so shipping bytes is
  exact and moves 4x less than f32) and draws the augmentation; centres,
  scales and joints travel in canvas coordinates. On the device, one
  finalize makes the batch: the rotated affine crop warp, the joint
  transform, ImageNet normalisation and the Gaussian targets. The crop
  warp follows the TPU package's gate: the two-pass filter (K4,
  ``ops.warp.affine_warp_two_pass``) whenever the canvas side is a
  multiple of 128 (the default canvas is 640), direct bilinear sampling
  (K2, ``ops.warp.affine_warp``) otherwise, on any device.
- Host warp: each decode thread draws its sample's augmentation (under a
  lock) and crops it with ``cv2.warpAffine`` (``process_sample``); the
  uint8 crops (``warpAffine`` of a uint8 image is integer-valued, so the
  bytes are exact) go to the device, where ``device_finalize`` casts,
  normalises and renders the targets. ``cv2`` is on no card's machine
  here, so this mode runs off the card.

The mode is the ``device_warp`` argument; unlike the JAX pipeline's, it
defaults to True, the mode the card runs. The host-warp mode can stylize
its crops on the device before they are normalised (the inline AdaIN
stylizer, ``models/adain.py``, with a bank of style exemplars; the
exemplar of each crop drawn from the pipeline's ``RandomState`` after
padding, as in the JAX package); the device-warp mode refuses a stylizer.

On a ``mesh`` of W ranks every rank's pipeline draws the same global
batch (same records, order and augmentation draws), padded to a multiple
of W, and uploads, warps and finalizes only its own rows
(``parallel/mesh.py::shard_batch``): the batch's device tensors are this
rank's rows, its host metadata the global batch's.

Spans (``utils/profiling.py``), in either mode: ``pipeline.batch`` a
batch, around ``pipeline.load`` (the main thread's wait on the decode
threads), ``pipeline.stack`` (stack and pad), ``pipeline.upload``
(``shard_batch``) and ``pipeline.finalize``; the counter
``pipeline.aug_lock_wait_s`` (the decode threads' wait for the
augmentation sampler, summed).
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
                                                 process_sample, read_image)
from stlpose_tpu_torch.ops.affine import apply_affine, get_affine_matrix
from stlpose_tpu_torch.ops.heatmap import generate_targets
from stlpose_tpu_torch.ops.warp import affine_warp, affine_warp_two_pass
from stlpose_tpu_torch.parallel.mesh import shard_batch
from stlpose_tpu_torch.utils.profiling import span


def _normalise(crops):
    """(N, 256, 192, 3) crops on the 0-255 scale -> ImageNet-normalised."""
    dev = crops.device
    return ((crops / 255.0 - torch.as_tensor(IMAGENET_MEAN, device=dev)) /
            torch.as_tensor(IMAGENET_STD, device=dev))


def device_finalize(crops, joints, vis):
    """The host-warp batch on the device: uint8 crops (N, 256, 192, 3)
    (or f32 on the 0-255 scale, from the stylizer), crop-space joints and
    visibility -> normalised f32 crops, targets (N, J, 64, 48) and target
    weights (N, J)."""
    x = _normalise(crops.to(torch.float32))
    target, weight = generate_targets(joints, vis,
                                      heatmap_size=HEATMAP_SIZE,
                                      image_size=IMAGE_SIZE)
    return x, target, weight


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
    x = _normalise(crops)
    mats = get_affine_matrix(centers, scales, rots, IMAGE_SIZE)
    joints_crop = apply_affine(joints, mats)
    joints_crop = torch.where(vis[..., None] > 0, joints_crop, joints)
    target, weight = generate_targets(joints_crop, vis,
                                      heatmap_size=HEATMAP_SIZE,
                                      image_size=IMAGE_SIZE)
    return x, target, weight, joints_crop


class PoseDataPipeline:
    """Iterable over device-ready batches of pose crops.

    Args:
      records: list of PoseRecord.
      batch_size: batch size.
      is_train: enables augmentation (with ``exp_data``).
      exp_data: experiment params; augmentation knobs are read from
        ``exp_data["dataset"]``.
      shuffle: shuffle each epoch.
      num_workers: host decode (and, with host warp, crop) threads.
      pad_multiple: pad the last batch to a multiple with repeated
        samples; "n_valid" marks the real entries.
      drop_last: drop the last partial batch.
      device_warp: crop on the device from letterbox canvases (True) or
        on the host with cv2 (False).
      canvas_size: side of the square letterbox canvas (device warp).
      device: where the batch is made ("cuda" unless told otherwise).
      stylizer, style_bank, style_alpha: the inline stylizer (an
        ``AdaINStylizer`` on ``device``), its exemplars (S, 256, 192, 3)
        in [0, 1] and its alpha; host warp only.
      mesh: make only this rank's rows on the device (None: all rows).
    """

    def __init__(self, records: Sequence[PoseRecord], batch_size: int,
                 is_train: bool, exp_data: dict | None = None,
                 shuffle: bool = False, num_workers: int = 8,
                 pad_multiple: int = 1, drop_last: bool = False,
                 seed: int = 13, device_warp: bool = True,
                 canvas_size: int = 640, device="cuda", stylizer=None,
                 style_bank=None, style_alpha=1.0, mesh=None):
        self.records = list(records)
        self.batch_size = batch_size
        self.is_train = is_train
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.pad_multiple = pad_multiple
        self.drop_last = drop_last
        self.device_warp = device_warp
        self.canvas_size = canvas_size
        self.device = resolve_device(device)
        self.mesh = mesh
        if device_warp and stylizer is not None:
            # the device-warp finalize normalises inside its own program;
            # skipping the stylizer there would be a wrong result
            raise ValueError("inline stylization is not supported with "
                             "device_warp=True; use the host-warp pipeline")
        self.stylizer = stylizer
        # the bank lives on the device: each batch indexes it there
        self.style_bank = (torch.as_tensor(np.asarray(style_bank, np.float32),
                                           device=self.device)
                           if style_bank is not None else None)
        self.style_alpha = style_alpha
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

    def _load_one(self, rec: PoseRecord):
        """Host-warp stage: decode, augmentation draw (serialised: the
        draws share one RandomState), then ``process_sample``."""
        img = read_image(rec.image)
        if self.aug is None:
            return process_sample(rec, img, None)
        drawn = self._draw(rec.center, rec.scale, rec.joints, rec.joints_vis)
        return process_sample(rec, img, _FrozenAug(*drawn))

    def _draw(self, *args):
        """One augmentation draw, serialised (the draws share one
        RandomState); the wait for the lock is the span
        ``pipeline.aug_lock_wait`` (a counter in a decode thread)."""
        with span("pipeline.aug_lock_wait"):
            self._aug_lock.acquire()
        try:
            return self.aug.sample(*args)
        finally:
            self._aug_lock.release()

    def _load_one_raw(self, rec: PoseRecord):
        """Device-warp stage: decode, then ``_letterbox``."""
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
            c, s, r, do_flip = self._draw(c, s, joints, vis)
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
        loader = self._load_one_raw if self.device_warp else self._load_one
        collate = (self._collate_device_warp if self.device_warp
                   else self._collate)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                with span("pipeline.batch"):
                    with span("pipeline.load"):
                        samples = list(pool.map(
                            lambda i: loader(self.records[i]), idx))
                    batch = collate(samples, [self.records[i] for i in idx])
                yield batch

    def _pad(self, n_valid: int, arrays: list, metas: list):
        """Repeat samples to fill the batch to a multiple of
        ``pad_multiple``."""
        pad = (-n_valid) % self.pad_multiple if self.pad_multiple > 1 else 0
        if not pad:
            return arrays, metas
        sel = np.arange(pad) % n_valid
        return ([np.concatenate([a, a[sel]]) for a in arrays],
                metas + [metas[i] for i in sel])

    def _upload(self, arrays: list) -> list:
        """``shard_batch`` of the host arrays (span ``pipeline.upload``)."""
        with span("pipeline.upload"):
            return shard_batch(self.mesh, arrays, self.device)

    @staticmethod
    def _host_meta(metas: list, n_valid: int) -> dict:
        """The batch's metadata, on the host, in original image
        coordinates."""
        return {
            "center": np.stack([m["center"] for m in metas]),
            "scale": np.stack([m["scale"] for m in metas]),
            "score": np.array([m["score"] for m in metas], np.float32),
            "image_id": np.array([m["image_id"] for m in metas], np.int64),
            "perceptual_loss": np.array(
                [m["perceptual_loss"] for m in metas], np.float32),
            "n_valid": n_valid,
        }

    def _collate(self, samples: List, recs: List[PoseRecord]) -> dict:
        """Stack the host-warp samples, move the uint8 crops and the
        joints to the device, stylize the crops when there is a stylizer
        (exemplar indices drawn after padding) and finalize; ``joints``
        and ``joints_vis`` stay host arrays, as in the JAX pipeline."""
        n_valid = len(samples)
        with span("pipeline.stack"):
            (crops, joints, vis), metas = self._pad(
                n_valid,
                [np.stack([s[k] for s in samples]) for k in range(3)],
                [s[3] for s in samples])
        sidx = None
        if self.stylizer is not None and self.style_bank is not None:
            sidx = self.rng.randint(0, len(self.style_bank), len(crops))
        crops_dev, joints_dev, vis_dev, sidx = self._upload(
            [crops.astype(np.uint8), joints, vis, sidx])
        with span("pipeline.finalize"):
            if sidx is not None:
                crops_dev = self.stylizer(
                    crops_dev.to(torch.float32) / 255.0,
                    self.style_bank[sidx], alpha=self.style_alpha) * 255.0
            x, target, weight = device_finalize(crops_dev, joints_dev,
                                                vis_dev)
        return {"image": x, "target": target, "target_weight": weight,
                "joints": joints, "joints_vis": vis,
                **self._host_meta(metas, n_valid)}

    def _collate_device_warp(self, samples: List, recs: List[PoseRecord]
                             ) -> dict:
        """Stack the host samples, move them to the device and finalize.
        ``joints`` (crop space) stays on the device; the metadata stays on
        the host, in original image coordinates."""
        n_valid = len(samples)
        with span("pipeline.stack"):
            arrays = [np.stack([s[k] for s in samples])
                      for k in (0, 1, 2, 4, 5)]
            arrays.insert(3, np.asarray([s[3] for s in samples], np.float32))
            arrays, metas = self._pad(n_valid, arrays,
                                      [s[6] for s in samples])
        uploaded = self._upload(arrays)
        with span("pipeline.finalize"):
            x, target, weight, joints_crop = device_warp_finalize(
                *uploaded,
                # no augmentation: rot is 0, the conditioning test is skipped
                may_rotate=self.aug is not None)
        return {"image": x, "target": target, "target_weight": weight,
                "joints": joints_crop, "joints_vis": arrays[5],
                **self._host_meta(metas, n_valid)}


class _FrozenAug:
    """Augmentation parameters drawn under the lock, handed to
    ``process_sample`` in place of the sampler."""

    def __init__(self, c, s, r, f):
        self._vals = (c, s, r, f)

    def sample(self, *args):
        return self._vals
