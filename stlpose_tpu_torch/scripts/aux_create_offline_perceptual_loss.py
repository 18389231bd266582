#!/usr/bin/env python
"""Precompute the styled-image -> perceptual-loss dictionary.

    python stlpose_tpu_torch/scripts/aux_create_offline_perceptual_loss.py
        [--alpha 0.5] [--styles redblack] [--split train|valid]
        [--data_path DIR] [--dict_path DIR] [--batch_size 64]
        [--vgg_weights vgg16-torchvision.pth] [--device cuda|cpu]

Counterpart of ``scripts/aux_create_offline_perceptual_loss.py``: for
every entry of ``<data>/mapping_dicts/{split}_dict_style_{s}_alpha_{a}.json``
whose styled and original images exist, both are read at 224x224 and
scored with the VGG16 perceptual loss (``models/vgg.py``; the torchvision
weights of ``--vgg_weights``, or seeded random features); the losses go
to ``<dict_path>/perceptual_loss_dict_alpha_{a}_styles_{s}.json``, keyed
by styled file name, which ``train/loss.py::load_perceptual_loss_dict``
reads.
"""

import argparse
import json
import os
import sys

import numpy as np

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from stlpose_tpu_torch import resolve_device  # noqa: E402
from stlpose_tpu_torch.config import CONFIG  # noqa: E402
from stlpose_tpu_torch.models.vgg import (VGG16Features,  # noqa: E402
                                          make_perceptual_loss_fn,
                                          vgg16_from_torchvision)


def read_image(path: str, size: int = 224) -> np.ndarray:
    """The RGB image at ``path`` resized to ``size`` x ``size``, f32 in
    [0, 1], through cv2."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return cv2.resize(img, (size, size)).astype(np.float32) / 255.0


def main(argv=None) -> str:
    """Returns the path of the JSON written."""
    p = argparse.ArgumentParser()
    p.add_argument("--alpha", default="0.5")
    p.add_argument("--styles", default="redblack")
    p.add_argument("--split", default="train", choices=["train", "valid"])
    p.add_argument("--data_path", default=None)
    p.add_argument("--dict_path", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--vgg_weights", default=None,
                   help=".pth with torchvision vgg16 features weights")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless cpu is asked for)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    data_path = args.data_path or CONFIG["paths"]["data_path"]
    dict_path = args.dict_path or CONFIG["paths"]["dict_path"]
    mapping_file = os.path.join(
        data_path, "mapping_dicts",
        f"{args.split}_dict_style_{args.styles}_alpha_{args.alpha}.json")
    with open(mapping_file) as f:
        mapping = json.load(f)

    styled_root = os.path.join(
        data_path, f"images_style_{args.styles}_alpha_{args.alpha}",
        args.split)
    orig_root = os.path.join(data_path, "original_images",
                             "train2017" if args.split == "train"
                             else "val2017")

    if args.vgg_weights:
        vgg = vgg16_from_torchvision(
            torch.load(args.vgg_weights, map_location="cpu",
                       weights_only=True), device=dev)
    else:
        vgg = VGG16Features(device=dev)
        print("WARNING: no --vgg_weights given; using random VGG features")
    loss_fn = make_perceptual_loss_fn(vgg)

    items = sorted(mapping.items())
    out = {}
    for start in range(0, len(items), args.batch_size):
        chunk = items[start:start + args.batch_size]
        styled, orig, names = [], [], []
        for img_id, styled_name in chunk:
            sp = os.path.join(styled_root, styled_name)
            op = os.path.join(orig_root, f"{img_id}.jpg")
            if not (os.path.exists(sp) and os.path.exists(op)):
                continue
            styled.append(read_image(sp))
            orig.append(read_image(op))
            names.append(styled_name)
        if not names:
            continue
        with torch.no_grad():
            losses = loss_fn(torch.from_numpy(np.stack(styled)).to(dev),
                             torch.from_numpy(np.stack(orig)).to(dev))
        for name, loss in zip(names, losses.cpu().numpy()):
            out[name] = float(loss)
        print(f"{len(out)}/{len(items)} scored", end="\r")

    os.makedirs(dict_path, exist_ok=True)
    out_path = os.path.join(
        dict_path,
        f"perceptual_loss_dict_alpha_{args.alpha}_styles_{args.styles}.json")
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(f"\nWrote {len(out)} perceptual losses to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
