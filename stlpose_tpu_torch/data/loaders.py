"""Dataset factory: experiment parameters -> pose records -> pipelines.

Port of the pose half of ``stlpose_tpu/data/loaders.py``
(``build_pose_records``, ``load_dataset``) with the same dataset names
and path layout: ``coco`` (GT boxes, or the person detector's boxes when
``evaluation.use_gt_bbox`` is false), ``styled_coco`` (the
``<data>/mapping_dicts`` name mapping), ``arch_data`` (the ClassArch
records, split by ``<dict_path>/arch_data_det_splits.json`` when it
exists) and ``combined`` (both). The pipelines crop on the device or on
the host as ``dataset.device_warp`` says. ``dataset.inline_style`` is
refused: the AdaIN stylizer comes with ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import json
import os

from stlpose_tpu_torch.config import CONFIG
from stlpose_tpu_torch.data import pose_dataset as pd
from stlpose_tpu_torch.data.pipeline import PoseDataPipeline

POSE_DATASETS = ("coco", "styled_coco", "arch_data", "combined")


def _styled_mapping(data_path, styles, alpha, train: bool):
    name = (f"train_dict_style_{styles}_alpha_{alpha}.json" if train
            else f"valid_dict_style_{styles}_alpha_{alpha}.json")
    path = os.path.join(data_path, "mapping_dicts", name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Styled-COCO mapping dict '{path}' missing; generate it with "
            "scripts/aux_styled_coco_preload.py")
    with open(path) as f:
        return json.load(f)


def build_pose_records(exp_data: dict, split: str,
                       perceptual_loss_dict=None, percentage=None,
                       data_path: str | None = None):
    """Pose records for one split ("train" or "valid") of the experiment's
    dataset; ``percentage`` keeps the first N% of the ClassArch train
    records."""
    data_path = data_path or CONFIG["paths"]["data_path"]
    name = exp_data["dataset"]["dataset_name"]
    alpha = exp_data["dataset"].get("alpha", "0.5")
    styles = exp_data["dataset"].get("styles", "redblack")
    train = split == "train"
    set_dir = "train2017" if train else "val2017"
    labels_file = os.path.join(
        data_path, "annotations", "person_keypoints_train.json" if train
        else "person_keypoints_val.json")
    img_root = os.path.join(data_path, "original_images", set_dir)

    if name == "coco":
        if train or exp_data["evaluation"].get("use_gt_bbox", True):
            return pd.load_coco_pose_records(labels_file, img_root,
                                             is_train=train)
        bbox_file = os.path.join(
            data_path, "annotations",
            "COCO_val2017_detections_AP_H_56_person.json")
        return pd.load_detection_result_records(
            bbox_file, img_root,
            image_thre=exp_data["evaluation"].get("img_thr", 0.0))
    if name == "styled_coco":
        mapping = _styled_mapping(data_path, styles, alpha, train)
        styled_root = os.path.join(
            data_path, f"images_style_{styles}_alpha_{alpha}",
            "train" if train else "valid")
        return pd.load_coco_pose_records(
            labels_file, img_root, is_train=train, styled_mapping=mapping,
            styled_img_root=styled_root, alpha=alpha,
            perceptual_loss_dict=perceptual_loss_dict)
    if name == "arch_data":
        records = pd.load_archdata_pose_records(
            os.path.join(data_path, "annotations_arch_data",
                         "arch_data_keypoints.json"),
            os.path.join(data_path, "class_arch_poses", "characters"))
        split_file = os.path.join(CONFIG["paths"]["dict_path"],
                                  "arch_data_det_splits.json")
        if os.path.exists(split_file):
            records = pd.canonical_archdata_split(
                records, split_file, "train" if train else "test")
        if percentage is not None and train:
            records = pd.percentage_subset(records, percentage)
        return records
    if name == "combined":
        return [rec for part in ("styled_coco", "arch_data")
                for rec in build_pose_records(
                    {**exp_data, "dataset": {**exp_data["dataset"],
                                             "dataset_name": part}},
                    split, perceptual_loss_dict, percentage, data_path)]
    raise ValueError(
        f"Dataset '{name}' not supported; use one of {POSE_DATASETS}")


def load_dataset(exp_data: dict, train: bool = True, validation: bool = True,
                 shuffle_train: bool = False, shuffle_valid: bool = False,
                 perceptual_loss_dict=None, num_workers: int | None = None,
                 pad_multiple: int = 1, data_path: str | None = None,
                 device="cuda"):
    """Pose pipelines for the experiment, cropping on the device or on the
    host as ``dataset.device_warp`` says and making their batches on
    ``device``. Returns (train_pipeline, valid_pipeline); either may be
    None."""
    d = exp_data["dataset"]
    if d.get("inline_style"):
        raise NotImplementedError(
            "load_dataset: dataset.inline_style is not ported yet: the "
            "AdaIN stylizer comes with ROADMAP Queue 1 item 4")
    dw = bool(d.get("device_warp", False))
    bs = exp_data["training"]["batch_size"]
    nw = num_workers if num_workers is not None else CONFIG["num_workers"]
    train_pipe = valid_pipe = None
    if train:
        recs = build_pose_records(exp_data, "train", perceptual_loss_dict,
                                  data_path=data_path)
        train_pipe = PoseDataPipeline(
            recs, bs, is_train=True, exp_data=exp_data,
            shuffle=shuffle_train, num_workers=nw,
            pad_multiple=pad_multiple, drop_last=True, device_warp=dw,
            device=device)
    if validation:
        recs = build_pose_records(exp_data, "valid", perceptual_loss_dict,
                                  data_path=data_path)
        valid_pipe = PoseDataPipeline(
            recs, bs, is_train=False, shuffle=shuffle_valid,
            num_workers=nw, pad_multiple=pad_multiple, device_warp=dw,
            device=device)
    return train_pipe, valid_pipe
