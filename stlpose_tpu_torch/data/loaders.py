"""Dataset factory: experiment parameters -> records -> pipelines.

Port of ``stlpose_tpu/data/loaders.py`` with the same dataset names and
path layout. Pose (``build_pose_records``, ``load_dataset``): ``coco``
(GT boxes, or the person detector's boxes when
``evaluation.use_gt_bbox`` is false), ``styled_coco`` (the
``<data>/mapping_dicts`` name mapping), ``arch_data`` (the ClassArch
records, split by ``<dict_path>/arch_data_det_splits.json`` when it
exists) and ``combined`` (both); the pipelines crop on the device or on
the host as ``dataset.device_warp`` says. Detection
(``get_detection_dataset``): those four and the image folders
``red_black`` and ``open_subset``. ``dataset.inline_style`` builds the
inline AdaIN stylizer (``models/adain.py::build_inline_stylizer``) for
the train split, and for validation too with ``apply_to_valid``. Also
``get_vase_subset``, the image-folder pipeline of the qualitative vase
evaluation.
"""

from __future__ import annotations

import json
import os

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import CONFIG
from stlpose_tpu_torch.data import detection_dataset as dd
from stlpose_tpu_torch.data import pose_dataset as pd
from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
from stlpose_tpu_torch.models.adain import build_inline_stylizer

POSE_DATASETS = ("coco", "styled_coco", "arch_data", "combined")
DETECTION_DATASETS = POSE_DATASETS + ("red_black", "open_subset")


def _styled_mapping(data_path, styles, alpha, train: bool):
    name = (f"train_dict_style_{styles}_alpha_{alpha}.json" if train
            else f"valid_dict_style_{styles}_alpha_{alpha}.json")
    path = os.path.join(data_path, "mapping_dicts", name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Styled-COCO mapping dict '{path}' missing; generate it with "
            "stlpose_tpu_torch/scripts/aux_styled_coco_preload.py")
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
                 device="cuda", mesh=None):
    """Pose pipelines for the experiment, cropping on the device or on the
    host as ``dataset.device_warp`` says and making their batches on
    ``device`` (on a ``mesh``, this rank's rows); ``dataset.inline_style``
    stylizes the train crops (and the validation crops with
    ``apply_to_valid``) on ``device``. Returns (train_pipeline,
    valid_pipeline); either may be None."""
    d = exp_data["dataset"]
    dw = bool(d.get("device_warp", False))
    ics = d.get("inline_style")
    stylizer, style_bank, style_alpha = build_inline_stylizer(ics,
                                                              device=device)
    styled_valid = bool(ics.get("apply_to_valid")) if ics else False
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
            device=device, stylizer=stylizer, style_bank=style_bank,
            style_alpha=style_alpha, mesh=mesh)
    if validation:
        recs = build_pose_records(exp_data, "valid", perceptual_loss_dict,
                                  data_path=data_path)
        valid_pipe = PoseDataPipeline(
            recs, bs, is_train=False, shuffle=shuffle_valid,
            num_workers=nw, pad_multiple=pad_multiple, device_warp=dw,
            device=device, stylizer=stylizer if styled_valid else None,
            style_bank=style_bank if styled_valid else None,
            style_alpha=style_alpha, mesh=mesh)
    return train_pipe, valid_pipe


def get_detection_dataset(exp_data: dict, split: str = "train",
                          shuffle: bool = False,
                          num_workers: int | None = None,
                          pad_multiple: int = 1,
                          data_path: str | None = None,
                          perceptual_loss_dict=None, device="cuda"):
    """The detection pipeline of one split ("train" or "valid") of the
    experiment's dataset, on ``dataset.image_size`` square canvases; the
    train split drops its last partial batch. ``dataset.inline_style``
    stylizes the train canvases (and the valid ones with
    ``apply_to_valid``) on ``device``, its exemplars resized to the
    canvas."""
    device = resolve_device(device)
    data_path = data_path or CONFIG["paths"]["data_path"]
    d = exp_data["dataset"]
    name = d["dataset_name"]
    alpha = d.get("alpha", "0.5")
    styles = d.get("styles", "redblack")
    img_size = d.get("image_size", 400)
    bs = exp_data["training"]["batch_size"]
    nw = num_workers if num_workers is not None else CONFIG["num_workers"]
    train = split == "train"
    labels_file = os.path.join(
        data_path, "annotations", "person_keypoints_train.json" if train
        else "person_keypoints_val.json")
    img_root = os.path.join(data_path, "original_images",
                            "train2017" if train else "val2017")

    if name == "coco":
        recs = dd.load_coco_detection_records(labels_file, img_root)
    elif name == "styled_coco":
        recs = dd.load_coco_detection_records(
            labels_file, img_root,
            styled_mapping=_styled_mapping(data_path, styles, alpha, train),
            styled_img_root=os.path.join(
                data_path, f"images_style_{styles}_alpha_{alpha}",
                "train" if train else "valid"),
            perceptual_loss_dict=perceptual_loss_dict)
    elif name == "arch_data":
        recs = dd.load_archdata_detection_records(
            os.path.join(data_path, "annotations_arch_data", "all_data.json"),
            os.path.join(data_path, "class_arch_data"))
    elif name in ("red_black", "open_subset"):
        recs = dd.list_directory_records(
            os.path.join(data_path, "class_arch_data", name))
    else:
        raise ValueError(f"Detection dataset '{name}' not supported; "
                         f"use one of {DETECTION_DATASETS}")
    ics = d.get("inline_style")
    stylizer, style_bank, style_alpha = build_inline_stylizer(
        ics if ics and (train or ics.get("apply_to_valid")) else None,
        crop_hw=(img_size, img_size), device=device)
    return dd.DetectionDataPipeline(
        recs, bs, img_size=img_size, shuffle=shuffle, num_workers=nw,
        pad_multiple=pad_multiple, drop_last=train, stylizer=stylizer,
        style_bank=style_bank, style_alpha=style_alpha)


def get_vase_subset(img_size: int = 400, dataset_name: str | None = None,
                    data_path: str | None = None, batch_size: int = 1,
                    num_workers: int | None = None):
    """The loose vase-image pipeline of the qualitative two-stage
    evaluation: the images of ``<data>/ccoimages_final``, or of
    ``<data>/<dataset_name>`` (red_black, open_subset, ...), falling back
    to ``<data>/class_arch_data/<dataset_name>`` when that is no
    directory."""
    data_path = data_path or CONFIG["paths"]["data_path"]
    sub = dataset_name or "ccoimages_final"
    d = os.path.join(data_path, sub)
    if not os.path.isdir(d) and dataset_name:
        d = os.path.join(data_path, "class_arch_data", dataset_name)
    recs = dd.list_directory_records(d)
    nw = num_workers if num_workers is not None else CONFIG["num_workers"]
    return dd.DetectionDataPipeline(recs, batch_size, img_size=img_size,
                                    num_workers=nw)
