"""Top-down pose records and the per-sample host stage of the input
pipeline.

Port of ``stlpose_tpu/data/pose_dataset.py``: GT-box records from a COCO
keypoint file (with the styled-COCO name mapping and the precomputed
perceptual-loss field), detector-box records from a person-detection
results file, the ClassArch single-instance records (their own
centre/scale convention, the canonical test split and the first-N%
subset), the train-time augmentation sampler (a numpy ``RandomState``
copied as it is, so a seed gives the same draws as the JAX package), the
host-warp stage ``process_sample`` (``cv2.warpAffine``) and the RGB image
read. ``cv2`` is imported only inside ``process_sample`` and
``read_image``: the card's machine has none.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from stlpose_tpu_torch import constants
from stlpose_tpu_torch.data.coco_api import COCO
from stlpose_tpu_torch.ops.affine import get_affine_matrix_np

# ClassArch character classes that count as person instances
PERSON_CHARACTER_FILTER = (
    "Heracles", "persecutor", "wrestler", "abductor", "abductee", "Triton",
    "bride", "groom", "Theseus", "Antaios", "Peleus", "Atalante", "Skiron",
    "Eros", "Thetis", "Nereus", "maenad", "satyr", "Anteros", "Procrustes",
    "fleeing", "Kerkyon",
)

IMAGE_SIZE = (192, 256)        # (w, h)
HEATMAP_SIZE = (48, 64)
ASPECT_RATIO = IMAGE_SIZE[0] / IMAGE_SIZE[1]
PIXEL_STD = 200.0


@dataclasses.dataclass
class PoseRecord:
    """One person instance."""
    image: str                  # path to the (possibly styled) image
    original_image: str         # path to the original COCO image
    image_id: int
    center: np.ndarray          # (2,)
    scale: np.ndarray           # (2,) pixel-std units
    joints: np.ndarray          # (J, 2)
    joints_vis: np.ndarray      # (J,) 0/1 visibility
    score: float = 1.0
    alpha: float = 0.0
    perceptual_loss: float = 0.0
    character_name: str = ""
    archdata_joints: Optional[np.ndarray] = None


def _xywh_to_cs(x, y, w, h, aspect_ratio=ASPECT_RATIO, pixel_std=PIXEL_STD,
                padding=1.25):
    """COCO xywh box -> (center, scale): the box grows to the crop's aspect
    ratio and is padded 1.25x."""
    cx, cy = x + w * 0.5, y + h * 0.5
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], np.float32) * padding
    return np.array([cx, cy], np.float32), scale


def _xywh_to_cs_archdata(x, y, w, h):
    """ClassArch variant: the box grows to the crop's aspect ratio, its
    scale is normalised by the crop size and not padded."""
    cx, cy = x + w * 0.5, y + h * 0.5
    if w > ASPECT_RATIO * h:
        h = w / ASPECT_RATIO
    elif w < ASPECT_RATIO * h:
        w = h * ASPECT_RATIO
    scale = np.array([w / IMAGE_SIZE[0], h / IMAGE_SIZE[1]], np.float32)
    return np.array([cx, cy], np.float32), scale


def load_coco_pose_records(labels_file, img_root, *, is_train: bool,
                           styled_mapping: dict | None = None,
                           styled_img_root: str | None = None,
                           alpha="0.5",
                           perceptual_loss_dict: dict | None = None
                           ) -> List[PoseRecord]:
    """GT-box pose records of a COCO keypoint annotation file: boxes
    clipped to the image, positive area, person class only, instances
    without a labelled keypoint skipped, visibility clipped to {0, 1}."""
    coco = COCO(labels_file)
    person_ids = coco.getCatIds(catNms=["person"]) or [1]
    records = []
    for img_id in coco.getImgIds():
        im = coco.loadImgs(img_id)[0]
        width, height = im["width"], im["height"]
        for ann in coco.loadAnns(coco.getAnnIds(imgIds=img_id, iscrowd=0)):
            if ann["category_id"] not in person_ids:
                continue
            x, y, w, h = ann["bbox"]
            x1, y1 = max(0, x), max(0, y)
            x2 = min(width - 1, x1 + max(0, w - 1))
            y2 = min(height - 1, y1 + max(0, h - 1))
            if ann["area"] <= 0 or x2 < x1 or y2 < y1:
                continue
            kp = ann.get("keypoints")
            if not kp or max(kp) == 0:
                continue
            kp = np.asarray(kp, np.float32).reshape(-1, 3)
            joints = kp[:, :2].copy()
            vis = np.clip(kp[:, 2], 0, 1)
            center, scale = _xywh_to_cs(x1, y1, x2 - x1, y2 - y1)

            original = os.path.join(img_root, "%012d.jpg" % img_id)
            image_path = original
            rec_alpha = float(alpha) if not isinstance(alpha, str) or \
                alpha.replace(".", "").isdigit() else 0.0
            if styled_mapping is not None:
                name = styled_mapping.get("%012d" % img_id)
                if name is None:
                    continue
                image_path = os.path.join(styled_img_root or img_root, name)
                if alpha == "random" and "alpha" in name:
                    rec_alpha = float(name.split("alpha_")[-1]
                                      .split(".jpg")[0])
            ploss = 0.0
            if perceptual_loss_dict:
                ploss = float(perceptual_loss_dict.get(
                    os.path.basename(image_path), 0.0))
            records.append(PoseRecord(
                image=image_path, original_image=original, image_id=img_id,
                center=center, scale=scale, joints=joints, joints_vis=vis,
                alpha=rec_alpha, perceptual_loss=ploss))
    return records


def load_detection_result_records(bbox_file, img_root, *,
                                  image_thre: float = 0.0,
                                  styled_mapping: dict | None = None,
                                  styled_img_root: str | None = None
                                  ) -> List[PoseRecord]:
    """Pose records from a person-detector results JSON (a list of
    {image_id, category_id, bbox xywh, score}): person boxes scoring at
    least ``image_thre``, all 17 joints marked visible at (0, 0)."""
    with open(bbox_file) as f:
        all_boxes = json.load(f)
    records = []
    for det in all_boxes:
        if det.get("category_id") != 1 or det["score"] < image_thre:
            continue
        img_id = det["image_id"]
        center, scale = _xywh_to_cs(*det["bbox"][:4])
        original = os.path.join(img_root, "%012d.jpg" % img_id)
        image_path = original
        if styled_mapping is not None:
            name = styled_mapping.get("%012d" % img_id)
            if name is None:
                continue
            image_path = os.path.join(styled_img_root or img_root, name)
        records.append(PoseRecord(
            image=image_path, original_image=original, image_id=img_id,
            center=center, scale=scale,
            joints=np.zeros((17, 2), np.float32),
            joints_vis=np.ones((17,), np.float32),
            score=float(det["score"])))
    return records


def load_archdata_pose_records(labels_file, img_root) -> List[PoseRecord]:
    """ClassArch pose records: the first annotated instance of each image,
    its COCO-17 keypoints, and the original 18-keypoint set in
    ``archdata_joints``."""
    coco = COCO(labels_file)
    records = []
    for img_id in coco.getImgIds():
        im = coco.loadImgs(img_id)[0]
        anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id, iscrowd=0))
        if not anns:
            continue
        ann = anns[0]
        kp = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
        arch_kp = np.asarray(ann.get("archdata_kpts", np.zeros(18 * 3)),
                             np.float32).reshape(-1, 3)
        center, scale = _xywh_to_cs_archdata(*ann["bbox"][:4])
        records.append(PoseRecord(
            image=os.path.join(img_root, im["file_name"]),
            original_image=im.get("full_name", im["file_name"]),
            image_id=img_id, center=center, scale=scale,
            joints=kp[:, :2].copy(), joints_vis=np.clip(kp[:, 2], 0, 1),
            score=float(ann.get("num_keypoints", 17)),
            character_name=ann.get("character_name", ""),
            archdata_joints=arch_kp))
    return records


def canonical_archdata_split(records, split_file, split_set: str):
    """The canonical ClassArch split: the "test" indices of the split
    JSON, in order, or ("train") every other record."""
    with open(split_file) as f:
        split = json.load(f)
    eval_idx = set(split["test"])
    if split_set == "train":
        keep = [i for i in range(len(records)) if i not in eval_idx]
    else:
        keep = sorted(eval_idx)
    return [records[i] for i in keep]


def percentage_subset(records, percentage: float):
    """The first ``percentage`` % of the records (1-100)."""
    if not 1 <= percentage <= 100:
        raise ValueError(f"percentage {percentage} is not in [1, 100]")
    n = int(np.round(len(records) * percentage / 100))
    return records[:n]


class AugmentationParams:
    """Sampler of the train-time augmentation: half-body zoom, scale,
    rotation (in [-2*rf, 2*rf] degrees, on 60% of samples) and flip."""

    def __init__(self, scale_factor=0.0, rotation_factor=0.0, flip=False,
                 num_joints_half_body=8, prob_half_body=0.0,
                 upper_body_ids=constants.UPPER_BODY_IDS, seed=13):
        self.sf = float(scale_factor)
        self.rf = float(rotation_factor)
        self.flip = bool(flip)
        self.nhb = num_joints_half_body
        self.phb = float(prob_half_body)
        self.upper = set(upper_body_ids)
        self.rng = np.random.RandomState(seed)

    def half_body(self, joints, vis):
        """Centre and scale of the upper or the lower body's visible
        joints, grown to the crop's aspect ratio and padded 1.5x."""
        upper = [joints[j] for j in range(len(joints))
                 if vis[j] > 0 and j in self.upper]
        lower = [joints[j] for j in range(len(joints))
                 if vis[j] > 0 and j not in self.upper]
        sel = upper if (self.rng.randn() < 0.5 and len(upper) > 2) else lower
        if len(sel) < 2:
            return None, None
        sel = np.asarray(sel, np.float32)
        center = sel.mean(axis=0)
        lt, rb = sel.min(axis=0), sel.max(axis=0)
        w, h = rb[0] - lt[0], rb[1] - lt[1]
        if w > ASPECT_RATIO * h:
            h = w / ASPECT_RATIO
        elif w < ASPECT_RATIO * h:
            w = h * ASPECT_RATIO
        scale = np.array([w / PIXEL_STD, h / PIXEL_STD], np.float32) * 1.5
        return center, scale

    def sample(self, center, scale, joints, vis):
        """(center, scale, rot, do_flip) for one training sample."""
        c, s, r = center.copy(), scale.copy(), 0.0
        if vis.sum() > self.nhb and self.rng.rand() < self.phb:
            c_h, s_h = self.half_body(joints, vis)
            if c_h is not None:
                c, s = c_h, s_h
        s = s * np.clip(self.rng.randn() * self.sf + 1,
                        1 - self.sf, 1 + self.sf)
        if self.rng.rand() <= 0.6 and self.rf > 0:
            r = float(np.clip(self.rng.randn() * self.rf,
                              -self.rf * 2, self.rf * 2))
        do_flip = bool(self.flip and self.rng.rand() <= 0.5)
        return c, s, r, do_flip


def flip_perm(num_joints):
    """Joint permutation of a horizontal mirror (left <-> right)."""
    perm = np.arange(num_joints)
    for a, b in constants.FLIP_PAIRS:
        perm[a], perm[b] = b, a
    return perm


def process_sample(record: PoseRecord, image: np.ndarray,
                   aug: AugmentationParams | None = None):
    """Host-warp stage for one sample: augmentation draw (and mirror),
    ``cv2.warpAffine`` of the crop and the joint transform. Returns
    (crop f32 (256, 192, 3) with integer values, joints (J, 2), vis (J,),
    meta); the Gaussian targets are made batched on the device."""
    import cv2

    joints = record.joints.copy()
    vis = record.joints_vis.copy()
    c, s, r = record.center.copy(), record.scale.copy(), 0.0

    if aug is not None:
        c, s, r, do_flip = aug.sample(c, s, joints, vis)
        if do_flip:
            image = image[:, ::-1, :]
            perm = flip_perm(len(joints))
            joints[:, 0] = image.shape[1] - joints[:, 0] - 1
            joints = joints[perm]
            vis = vis[perm]
            joints = joints * vis[:, None]
            c[0] = image.shape[1] - c[0] - 1

    trans = get_affine_matrix_np(c, s, r, IMAGE_SIZE)
    crop = cv2.warpAffine(image, trans.astype(np.float64),
                          (IMAGE_SIZE[0], IMAGE_SIZE[1]),
                          flags=cv2.INTER_LINEAR)
    ones = np.ones((len(joints), 1))
    pts = np.concatenate([joints, ones], axis=1) @ trans.T
    joints_out = np.where(vis[:, None] > 0, pts[:, :2], joints)

    meta = {"center": c.astype(np.float32), "scale": s.astype(np.float32),
            "rotation": np.float32(r), "score": np.float32(record.score),
            "image_id": np.int64(record.image_id),
            "perceptual_loss": np.float32(record.perceptual_loss)}
    return crop.astype(np.float32), joints_out.astype(np.float32), \
        vis.astype(np.float32), meta


def read_image(path: str) -> np.ndarray:
    """RGB uint8 image read with cv2 (imported here: the card's machine has
    no cv2, so images are decoded off the card)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise ValueError(f"Failed to read image '{path}'")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
