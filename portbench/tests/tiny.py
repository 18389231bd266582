"""A copy of the benchmark's files at test sizes: HRNet and Faster R-CNN
at thin widths (the program's own test presets), small traffic, for runs
on the CPU through the port's plain versions."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HRNET_TINY = {"num_joints": 17, "final_conv_kernel": 1, "stem_channels": 16,
              "stage1_num_blocks": 1,
              "stages": [{"num_modules": 1, "num_branches": 2,
                          "num_blocks": [1, 1], "num_channels": [8, 16]},
                         {"num_modules": 1, "num_branches": 3,
                          "num_blocks": [1, 1, 1],
                          "num_channels": [8, 16, 32]},
                         {"num_modules": 1, "num_branches": 4,
                          "num_blocks": [1, 1, 1, 1],
                          "num_channels": [8, 16, 32, 64]}],
              "image_size": [192, 256], "heatmap_size": [48, 64]}
FRCNN_TINY = {"stage_sizes": [1, 1, 1, 1], "width": 8, "fpn_channels": 32,
              "image_size": 128, "pre_nms_top_n_train": 64,
              "pre_nms_top_n_test": 64, "post_nms_top_n_train": 32,
              "post_nms_top_n_test": 32, "roi_batch_per_image": 32,
              "detections_per_img": 8}
TRAFFIC = {"serve_fused": {"batch": 2, "image_size": 128, "batches": 2,
                           "judged_calls": 2},
           "train_step": {"batch": 2, "records": 6, "canvas": 128},
           "extract_flip": {"batch": 2, "images": 4, "height": 128,
                            "width": 64, "canvas": 128, "num_workers": 2,
                            "judged_batches": 2}}


def tiny_copy(dest: str) -> str:
    """``dest`` holding BENCHMARK.json and portbench/ with every config
    and cell cut to test sizes (limits and all else kept)."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    pkg = os.path.join(dest, "portbench")
    shutil.copytree(os.path.join(REPO, "portbench"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in os.listdir(os.path.join(pkg, "configs")):
        path = os.path.join(pkg, "configs", name)
        cfg = json.load(open(path))
        cfg["pose"] = HRNET_TINY
        if "detector" in cfg:
            cfg["detector"] = {**cfg["detector"], **FRCNN_TINY}
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(pkg, "workloads")):
        path = os.path.join(pkg, "workloads", name)
        wl = json.load(open(path))
        full = wl["traffic"]
        wl["traffic"] = {**full, **TRAFFIC[wl["driver"]]}
        if "crop_budget" in full:      # the same crops an image
            wl["traffic"]["crop_budget"] = max(
                1, full["crop_budget"] * wl["traffic"]["batch"] //
                full["batch"])
        json.dump(wl, open(path, "w"))
    return dest
