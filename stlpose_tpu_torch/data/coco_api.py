"""Minimal in-memory COCO annotation index.

Port of ``stlpose_tpu/data/coco_api.py``, the pycocotools ``COCO`` surface
the framework needs: index construction, id queries with their filters,
load helpers, ``loadRes`` for detection and keypoint result lists (the
area and keypoint-extent bbox rules of pycocotools) and
``coco_from_dataset`` for datasets without an annotation file. Pure
Python and numpy.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            self.create_index()

    def create_index(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns, self.cat_to_imgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    # ------------------------------------------------------------- queries
    def getImgIds(self, imgIds=None, catIds=None):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if not imgIds and not catIds:
            return sorted(self.imgs.keys())
        ids = set(imgIds) if imgIds else None
        for cat in catIds:
            found = set(self.cat_to_imgs[cat])
            ids = found if ids is None else ids & found
        return sorted(ids) if ids is not None else []

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cs = set(catIds)
            anns = [a for a in anns if a["category_id"] in cs]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        cats = list(self.cats.values())
        if catNms:
            ns = set(_as_list(catNms))
            cats = [c for c in cats if c["name"] in ns]
        if catIds:
            cs = set(_as_list(catIds))
            cats = [c for c in cats if c["id"] in cs]
        return [c["id"] for c in cats]

    def loadAnns(self, ids):
        return [self.anns[i] for i in _as_list(ids)]

    def loadImgs(self, ids):
        return [self.imgs[i] for i in _as_list(ids)]

    def loadCats(self, ids):
        return [self.cats[i] for i in _as_list(ids)]

    # -------------------------------------------------------------- results
    def loadRes(self, res) -> "COCO":
        """Build a results COCO from a list of result dicts or a JSON path.

        Mirrors pycocotools semantics the eval stack relies on: bbox results
        get area = w*h and segmentation omitted; keypoint results get a
        bbox/area computed from the keypoint extent.
        """
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        out = COCO()
        out.dataset = {"images": list(self.dataset.get("images", [])),
                       "categories": copy.deepcopy(
                           self.dataset.get("categories", []))}
        anns = copy.deepcopy(res)
        img_ids = set(self.imgs.keys())
        for i, ann in enumerate(anns):
            if ann["image_id"] not in img_ids:
                raise ValueError(f"result image_id {ann['image_id']} not in "
                                 "ground truth")
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
            if "keypoints" in ann and "bbox" not in ann:
                kp = np.asarray(ann["keypoints"], np.float64)
                x, y = kp[0::3], kp[1::3]
                x0, x1 = float(x.min()), float(x.max())
                y0, y1 = float(y.min()), float(y.max())
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            elif "bbox" in ann and "area" not in ann:
                bb = ann["bbox"]
                ann["area"] = bb[2] * bb[3]
        out.dataset["annotations"] = anns
        out.create_index()
        return out


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple, set, np.ndarray)):
        return list(x)
    return [x]


def coco_from_dataset(samples, categories=None) -> COCO:
    """Fit an in-memory COCO GT object from arbitrary dataset samples.

    Equivalent of the reference's ``convert_to_coco_api``
    (lib/detection_coco_utils.py:146-196): used to evaluate on datasets
    (ClassArch, ad-hoc splits) that have no COCO annotation file.

    Args:
      samples: iterable of dicts with keys image_id, height, width, and
        per-instance boxes (xyxy), labels, optional keypoints / iscrowd.
    """
    images, annotations = [], []
    cat_ids = set()
    ann_id = 1
    for s in samples:
        images.append({"id": s["image_id"], "height": s.get("height", 0),
                       "width": s.get("width", 0)})
        boxes = np.asarray(s.get("boxes", np.zeros((0, 4))), np.float64)
        labels = list(s.get("labels", [1] * len(boxes)))
        for k in range(len(boxes)):
            x1, y1, x2, y2 = boxes[k]
            ann = {"id": ann_id, "image_id": s["image_id"],
                   "category_id": int(labels[k]),
                   "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                   "area": float((x2 - x1) * (y2 - y1)),
                   "iscrowd": int(s.get("iscrowd", [0] * len(boxes))[k])}
            if "keypoints" in s:
                kp = np.asarray(s["keypoints"][k], np.float64).reshape(-1)
                ann["keypoints"] = kp.tolist()
                ann["num_keypoints"] = int((kp[2::3] > 0).sum())
            annotations.append(ann)
            cat_ids.add(int(labels[k]))
            ann_id += 1
    if categories is None:
        categories = [{"id": c, "name": str(c)} for c in sorted(cat_ids or {1})]
    return COCO({"images": images, "annotations": annotations,
                 "categories": categories})
