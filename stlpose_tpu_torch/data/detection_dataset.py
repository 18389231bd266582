"""Detection records and the detection input pipeline.

Port of ``stlpose_tpu/data/detection_dataset.py``: ``DetectionRecord``;
the person-class records of a COCO file (box sanitisation, the
Styled-COCO name mapping and perceptual losses) and of the ClassArch
file (string boxes, person-like characters only); the unannotated
image-folder records of the qualitative vase evaluation
(``list_directory_records``); the longest-side resize and zero pad to a
square canvas with boxes rescaled (``resize_letterbox``); and
``DetectionDataPipeline``, which makes fixed-shape host batches of
canvases and padded box arrays, with the canvases stylized on the device
when it has an inline stylizer (photometric only: boxes, labels and masks
are untouched). Images are decoded with ``cv2`` on the host; the card's
machine has none, so the pipeline's ``_load_one`` is where decoded
canvases can be given instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np
import torch

from stlpose_tpu_torch.data.coco_api import COCO
from stlpose_tpu_torch.data.pose_dataset import (PERSON_CHARACTER_FILTER,
                                                 read_image)


@dataclasses.dataclass
class DetectionRecord:
    image: str
    image_id: int
    boxes: np.ndarray        # (K, 4) xyxy in original pixels
    labels: np.ndarray       # (K,)
    areas: np.ndarray        # (K,)
    iscrowd: np.ndarray      # (K,)
    perceptual_loss: float = 0.0


def load_coco_detection_records(labels_file, img_root, *,
                                styled_mapping: dict | None = None,
                                styled_img_root: str | None = None,
                                perceptual_loss_dict: dict | None = None
                                ) -> List[DetectionRecord]:
    """Person-class records of a COCO file: crowd and non-person
    annotations dropped, boxes clipped to the image, degenerate boxes
    dropped, images left with no box skipped; with ``styled_mapping``,
    the styled image in place of the original (images without one
    skipped) and its perceptual loss from ``perceptual_loss_dict``."""
    coco = COCO(labels_file)
    person_ids = set(coco.getCatIds(catNms=["person"]) or [1])
    records = []
    for img_id in coco.getImgIds():
        im = coco.loadImgs(img_id)[0]
        W, H = im["width"], im["height"]
        boxes, labels, areas, crowd = [], [], [], []
        for ann in coco.loadAnns(coco.getAnnIds(imgIds=img_id)):
            if ann["category_id"] not in person_ids or ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann["bbox"]
            x1, y1 = max(0.0, x), max(0.0, y)
            x2, y2 = min(W - 1.0, x1 + max(0.0, w - 1)), \
                min(H - 1.0, y1 + max(0.0, h - 1))
            if ann["area"] <= 0 or x2 <= x1 or y2 <= y1:
                continue
            boxes.append([x1, y1, x2, y2])
            labels.append(1)
            areas.append(ann["area"])
            crowd.append(0)
        if not boxes:
            continue
        path = os.path.join(img_root, im.get("file_name",
                                             "%012d.jpg" % img_id))
        ploss = 0.0
        if styled_mapping is not None:
            name = styled_mapping.get("%012d" % img_id)
            if name is None:
                continue
            path = os.path.join(styled_img_root or img_root, name)
        if perceptual_loss_dict:
            ploss = float(perceptual_loss_dict.get(os.path.basename(path),
                                                   0.0))
        records.append(DetectionRecord(
            image=path, image_id=img_id,
            boxes=np.asarray(boxes, np.float32),
            labels=np.asarray(labels, np.int32),
            areas=np.asarray(areas, np.float32),
            iscrowd=np.asarray(crowd, np.int32),
            perceptual_loss=ploss))
    return records


def load_archdata_detection_records(labels_file, img_root,
                                    person_filter: tuple | None = None
                                    ) -> List[DetectionRecord]:
    """ClassArch records: boxes given as "x1,y1,x2,y2" strings (or
    lists), kept only for the characters in ``person_filter``
    (``PERSON_CHARACTER_FILTER`` by default); one record per image that
    keeps a box, in the order of the annotations."""
    person_filter = person_filter or PERSON_CHARACTER_FILTER
    with open(labels_file) as f:
        annotations = json.load(f)
    label_map = {c["id"]: c["name"] for c in annotations.get("categories", [])}
    per_img = {}
    for ann in annotations.get("annotations", []):
        if isinstance(ann["bbox"], str):
            x1, y1, x2, y2 = [int(v) for v in ann["bbox"].split(",")]
        else:
            x1, y1, x2, y2 = ann["bbox"]
        if label_map.get(ann["category_id"], "") not in person_filter:
            continue
        per_img.setdefault(ann["image_id"], []).append(
            (x1, y1, x2, y2, (x2 - x1) * (y2 - y1)))
    images = {im["id"]: im for im in annotations.get("images", [])}
    records = []
    for img_id, boxes in per_img.items():
        im = images.get(img_id, {})
        arr = np.asarray([b[:4] for b in boxes], np.float32)
        records.append(DetectionRecord(
            image=os.path.join(img_root, im.get("file_name", "")),
            image_id=img_id, boxes=arr,
            labels=np.ones((len(arr),), np.int32),
            areas=np.asarray([b[4] for b in boxes], np.float32),
            iscrowd=np.zeros((len(arr),), np.int32)))
    return records


def list_directory_records(img_dir, exts=(".jpg", ".jpeg", ".png")
                           ) -> List[DetectionRecord]:
    """One box-less record per image file of ``img_dir``, in name order;
    ``image_id`` is the file's position in the directory listing."""
    records = []
    for i, name in enumerate(sorted(os.listdir(img_dir))):
        if os.path.splitext(name)[1].lower() not in exts:
            continue
        records.append(DetectionRecord(
            image=os.path.join(img_dir, name), image_id=i,
            boxes=np.zeros((0, 4), np.float32),
            labels=np.zeros((0,), np.int32),
            areas=np.zeros((0,), np.float32),
            iscrowd=np.zeros((0,), np.int32)))
    return records


def resize_letterbox(image: np.ndarray, boxes: np.ndarray, img_size: int):
    """Longest-side resize (``cv2``, bilinear) and zero pad to (img_size,
    img_size), boxes rescaled. Returns (canvas, boxes, scale_factor)."""
    import cv2

    h, w = image.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.zeros((img_size, img_size, image.shape[2]), resized.dtype)
    canvas[:nh, :nw] = resized
    return canvas, boxes * scale if len(boxes) else boxes, scale


class DetectionDataPipeline:
    """Fixed-shape detection batches: square canvases and padded boxes.

    Batch layout: image (N, S, S, 3) float32 in [0, 1], boxes (N,
    max_boxes, 4) xyxy on the canvas, labels and box_mask (N, max_boxes),
    scale (N,), image_id (N,), perceptual_loss (N,), and n_valid, the
    number of real samples (a tail batch is padded with repeats of its own
    samples to ``pad_multiple`` only when that is above 1). With a
    stylizer (an ``AdaINStylizer``, its exemplars (S, img_size, img_size,
    3) in [0, 1] and its alpha), image is the stylized batch, f32 on the
    stylizer's device, the exemplar of each canvas drawn from the
    pipeline's ``RandomState`` after padding.
    """

    def __init__(self, records, batch_size: int, img_size: int = 400,
                 max_boxes: int = 32, shuffle: bool = False,
                 num_workers: int = 8, pad_multiple: int = 1,
                 drop_last: bool = False, seed: int = 13, stylizer=None,
                 style_bank=None, style_alpha=1.0):
        self.records = list(records)
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.pad_multiple = pad_multiple
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.stylizer = stylizer
        # the bank lives on the stylizer's device: each batch indexes it
        # there
        self.style_bank = (torch.as_tensor(np.asarray(style_bank, np.float32),
                                           device=stylizer.device)
                           if stylizer is not None and style_bank is not None
                           else None)
        self.style_alpha = style_alpha

    def __len__(self):
        n = len(self.records)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _load_one(self, rec: DetectionRecord):
        img = read_image(rec.image).astype(np.float32)
        canvas, boxes, scale = resize_letterbox(img, rec.boxes.copy(),
                                                self.img_size)
        k = min(len(boxes), self.max_boxes)
        out_boxes = np.zeros((self.max_boxes, 4), np.float32)
        out_labels = np.zeros((self.max_boxes,), np.int32)
        mask = np.zeros((self.max_boxes,), np.float32)
        if k:
            out_boxes[:k] = boxes[:k]
            out_labels[:k] = rec.labels[:k]
            mask[:k] = 1.0
        return (canvas / 255.0, out_boxes, out_labels, mask,
                np.float32(scale), np.int64(rec.image_id),
                np.float32(rec.perceptual_loss))

    def __iter__(self):
        import concurrent.futures as cf

        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                out = list(pool.map(
                    lambda i: self._load_one(self.records[i]), idx))
                yield self._collate(out)

    def _collate(self, samples):
        n_valid = len(samples)
        pad = (-n_valid) % self.pad_multiple if self.pad_multiple > 1 else 0
        if pad:
            samples = samples + [samples[i % n_valid] for i in range(pad)]

        def stack(k):
            return np.stack([s[k] for s in samples])

        images = stack(0)
        if self.stylizer is not None and self.style_bank is not None:
            sidx = self.rng.randint(0, len(self.style_bank), len(images))
            images = self.stylizer(
                images, self.style_bank[torch.from_numpy(sidx).to(
                    self.style_bank.device)], alpha=self.style_alpha)
        return {"image": images, "boxes": stack(1), "labels": stack(2),
                "box_mask": stack(3), "scale": stack(4),
                "image_id": stack(5), "perceptual_loss": stack(6),
                "n_valid": n_valid}
