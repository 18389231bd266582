"""Keypoint submission generation and COCO AP computation.

Port of ``stlpose_tpu/eval/submission.py``: per-image rescoring and
OKS-NMS, the results file (a JSON list of ``{image_id, category_id,
keypoints[51], score, center, scale}``, merged into what the file already
holds), COCO keypoint AP over the evaluated images and COCO bbox AP.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from stlpose_tpu_torch.data.coco_api import COCO
from stlpose_tpu_torch.eval.cocoeval import COCOeval
from stlpose_tpu_torch.ops.nms import oks_nms, soft_oks_nms
from stlpose_tpu_torch.utils.experiment import load_predictions


def rescore_and_nms(all_preds, all_boxes, image_ids,
                    in_vis_thr: float = 0.2, oks_thr: float = 0.9,
                    soft: bool = False):
    """Per-image keypoint rescoring + OKS-NMS.

    Reference semantics (lib/metrics.py:236-258): each person's score becomes
    ``mean(joint scores above in_vis_thr) * box_score``; then greedy OKS-NMS
    at oks_thr; if NMS keeps nothing the whole image set is kept.

    Args:
      all_preds: (N, 17, 3) decoded keypoints [x, y, score].
      all_boxes: (N, 6) [center_x, center_y, scale_x, scale_y, area, score].
      image_ids: length-N list of image ids.
    Returns:
      list (per image) of lists of person dicts.
    """
    all_preds = np.asarray(all_preds)
    all_boxes = np.asarray(all_boxes)
    per_img = defaultdict(list)
    for idx in range(len(all_preds)):
        per_img[image_ids[idx]].append({
            "keypoints": all_preds[idx],
            "center": all_boxes[idx][0:2],
            "scale": all_boxes[idx][2:4],
            "area": all_boxes[idx][4],
            "score": all_boxes[idx][5],
            "image": image_ids[idx],
        })

    out = []
    for img, people in per_img.items():
        for person in people:
            joint_scores = person["keypoints"][:, 2]
            valid = joint_scores > in_vis_thr
            kpt_score = (joint_scores[valid].mean() if valid.any() else 0.0)
            person["score"] = float(kpt_score * person["score"])
        keep = (soft_oks_nms(people, oks_thr) if soft
                else oks_nms(people, oks_thr))
        out.append(people if len(keep) == 0 else [people[k] for k in keep])
    return out


def to_coco_results(nmsed_kpts):
    """Person dicts -> COCO result records (the reference's converter at
    data_processing.py:52-82)."""
    results = []
    for img_kpts in nmsed_kpts:
        for person in img_kpts:
            kp = np.asarray(person["keypoints"], np.float64)
            results.append({
                "image_id": person["image"],
                "category_id": 1,
                "keypoints": kp.reshape(-1).tolist(),
                "score": float(person["score"]),
                "center": np.asarray(person["center"]).tolist(),
                "scale": np.asarray(person["scale"]).tolist(),
            })
    return results


def generate_submission(all_preds, all_boxes, image_ids, preds_file,
                        name: bool = False, in_vis_thr: float = 0.2,
                        oks_thr: float = 0.9, soft: bool = False):
    """Rescoring + OKS-NMS + merge-into-results-file
    (reference: lib/metrics.py:192-265).

    Args:
      name: if True, image ids are file names and the numeric id is the last
        12 digits of the stem (MS-COCO naming).
    """
    if len(all_preds) and isinstance(all_preds[0], np.ndarray):
        all_preds = np.concatenate([np.atleast_3d(p) for p in all_preds],
                                   axis=0) if all_preds[0].ndim == 3 else \
            np.asarray(all_preds)
    all_preds = np.asarray(all_preds)
    all_boxes = np.asarray(all_boxes)
    if name:
        image_ids = [int(str(n)[-16:-4]) for n in image_ids]

    nmsed = rescore_and_nms(all_preds, all_boxes, image_ids,
                            in_vis_thr=in_vis_thr, oks_thr=oks_thr,
                            soft=soft)
    results = load_predictions(preds_file) + to_coco_results(nmsed)
    with open(preds_file, "w") as f:
        json.dump(results, f)
    return results


def compute_precision(preds_file: str, labels, summarize: bool = False):
    """COCO keypoint AP restricted to the evaluated images
    (reference: lib/metrics.py:156-189).

    Args:
      preds_file: path to the submission JSON.
      labels: annotation-file path or a COCO object.
    Returns the 10-stat keypoint vector.
    """
    coco_gt = labels if isinstance(labels, COCO) else COCO(labels)
    coco_dt = coco_gt.loadRes(preds_file)
    ev = COCOeval(coco_gt, coco_dt, "keypoints")
    preds = load_predictions(preds_file)
    ev.params.imgIds = sorted({p["image_id"] for p in preds})
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize()
    return stats


def compute_detection_ap(results, labels, img_ids=None):
    """COCO bbox AP for detector evaluation (the reference's CocoEvaluator
    path, lib/detection_coco_eval.py:17-61).

    Args:
      results: list of {image_id, category_id, bbox xywh, score} or a path.
      labels: annotation-file path or COCO object.
    Returns the 12-stat bbox vector.
    """
    coco_gt = labels if isinstance(labels, COCO) else COCO(labels)
    coco_dt = coco_gt.loadRes(results)
    ev = COCOeval(coco_gt, coco_dt, "bbox")
    if img_ids is not None:
        ev.params.imgIds = sorted(img_ids)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize()
