"""Minimal in-memory COCO annotation index: the part of
``stlpose_tpu/data/coco_api.py`` that ``load_coco_pose_records`` uses
(index construction, id queries, load helpers)."""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            self.create_index()

    def create_index(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getImgIds(self):
        return sorted(self.imgs.keys())

    def getAnnIds(self, imgIds=None, iscrowd=None):
        imgIds = _as_list(imgIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        else:
            anns = list(self.anns.values())
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None):
        cats = list(self.cats.values())
        if catNms:
            names = set(_as_list(catNms))
            cats = [c for c in cats if c["name"] in names]
        return [c["id"] for c in cats]

    def loadAnns(self, ids):
        return [self.anns[i] for i in _as_list(ids)]

    def loadImgs(self, ids):
        return [self.imgs[i] for i in _as_list(ids)]


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple, set, np.ndarray)):
        return list(x)
    return [x]
