"""Detection records and the detection input pipeline (inference half).

Port of the inference half of ``stlpose_tpu/data/detection_dataset.py``:
``DetectionRecord``, the unannotated image-folder records of the
qualitative vase evaluation (``list_directory_records``), the
longest-side resize and zero pad to a square canvas with boxes rescaled
(``resize_letterbox``), and ``DetectionDataPipeline``, which makes
fixed-shape host batches of canvases and padded box arrays. Images are
decoded with ``cv2`` on the host; the card's machine has none, so the
pipeline's ``_load_one`` is where decoded canvases can be given instead.
The COCO and ClassArch detection records and the inline stylizer come
with detector training (ROADMAP Queue 1 items 5 and 4).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from stlpose_tpu_torch.data.pose_dataset import read_image


@dataclasses.dataclass
class DetectionRecord:
    image: str
    image_id: int
    boxes: np.ndarray        # (K, 4) xyxy in original pixels
    labels: np.ndarray       # (K,)
    areas: np.ndarray        # (K,)
    iscrowd: np.ndarray      # (K,)
    perceptual_loss: float = 0.0


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
    samples to ``pad_multiple`` only when that is above 1).
    """

    def __init__(self, records, batch_size: int, img_size: int = 400,
                 max_boxes: int = 32, shuffle: bool = False,
                 num_workers: int = 8, pad_multiple: int = 1,
                 drop_last: bool = False, seed: int = 13, stylizer=None):
        if stylizer is not None:
            raise NotImplementedError(
                "DetectionDataPipeline: the inline stylizer is not ported "
                "yet; it comes with ROADMAP Queue 1 item 4")
        self.records = list(records)
        self.batch_size = batch_size
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.pad_multiple = pad_multiple
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

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

        return {"image": stack(0), "boxes": stack(1), "labels": stack(2),
                "box_mask": stack(3), "scale": stack(4),
                "image_id": stack(5), "perceptual_loss": stack(6),
                "n_valid": n_valid}
