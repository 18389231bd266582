#!/usr/bin/env python
"""Make Styled-COCO: stylize COCO images with the AdaIN stylizer and write
the name-mapping dict the datasets read.

    python stlpose_tpu_torch/scripts/aux_styled_coco_preload.py
        --style_dir <vase crops> [--alpha 0.5|random] [--styles redblack]
        [--split train|valid] [--data_path DIR] [--batch_size 32]
        [--size 512] [--decoder_ckpt decoder.npz]
        [--vgg_weights vgg16-torchvision.pth] [--limit N]
        [--device cuda|cpu]

Counterpart of ``scripts/aux_styled_coco_preload.py``: every
``<data>/original_images/{train,val}2017/*.jpg`` (the first ``--limit``)
is resized to a ``--size`` square, stylized in batches with an exemplar
of ``--style_dir`` drawn at random (``models/adain.py::AdaINStylizer``,
its encoder from ``--vgg_weights`` and decoder from ``--decoder_ckpt``,
seeded otherwise), resized back and written as a JPEG under
``<data>/images_style_{s}_alpha_{a}/{split}``; the mapping goes to
``<data>/mapping_dicts/{split}_dict_style_{s}_alpha_{a}.json``. The numpy
draws are the JAX script's: ``RandomState(CONFIG["random_seed"])``, then
the per-image alphas of ``--alpha random`` (uniform in 0.3-1.0), then the
exemplar indices of each batch.
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
from stlpose_tpu_torch.models import adain  # noqa: E402


def read_square(path: str, size: int):
    """(the RGB image at ``path`` resized to ``size`` x ``size``, f32 in
    [0, 1]; its (H, W) as read), through cv2."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return (cv2.resize(img, (size, size)).astype(np.float32) / 255.0,
            img.shape[:2])


def write_resized(path: str, img: np.ndarray, hw):
    """Write the f32 RGB ``img`` in [0, 1] resized to (H, W) = ``hw`` as
    the JPEG ``path`` (uint8 by truncation), through cv2."""
    import cv2

    img = cv2.resize(img, (hw[1], hw[0]))
    cv2.imwrite(path, cv2.cvtColor((img * 255).astype(np.uint8),
                                   cv2.COLOR_RGB2BGR))


def main(argv=None) -> str:
    """Returns the path of the mapping dict written."""
    p = argparse.ArgumentParser()
    p.add_argument("--style_dir", required=True,
                   help="directory of style exemplar images")
    p.add_argument("--alpha", default="0.5")
    p.add_argument("--styles", default="redblack",
                   help="style-set name used in directory/dict names")
    p.add_argument("--split", default="train", choices=["train", "valid"])
    p.add_argument("--data_path", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--size", type=int, default=512,
                   help="stylization canvas (square side)")
    p.add_argument("--decoder_ckpt", default=None,
                   help="npz with trained AdaIN decoder params")
    p.add_argument("--vgg_weights", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless cpu is asked for)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    data_path = args.data_path or CONFIG["paths"]["data_path"]
    orig_root = os.path.join(data_path, "original_images",
                             "train2017" if args.split == "train"
                             else "val2017")
    out_root = os.path.join(
        data_path, f"images_style_{args.styles}_alpha_{args.alpha}",
        args.split)
    os.makedirs(out_root, exist_ok=True)

    stylizer = adain.AdaINStylizer(
        adain.load_vgg_encoder(args.vgg_weights, dev) if args.vgg_weights
        else None,
        adain.load_decoder_npz(args.decoder_ckpt, dev) if args.decoder_ckpt
        else None, device=dev)

    # the bank lives on the device: each batch indexes it there
    style_bank = torch.as_tensor(adain.read_style_bank(
        args.style_dir, (args.size, args.size)), device=dev)

    names = sorted(f for f in os.listdir(orig_root) if f.endswith(".jpg"))
    if args.limit:
        names = names[:args.limit]
    rng = np.random.RandomState(CONFIG["random_seed"])
    mapping = {}
    alpha_val = (rng.uniform(0.3, 1.0, len(names))
                 if args.alpha == "random"
                 else np.full(len(names), float(args.alpha)))

    for start in range(0, len(names), args.batch_size):
        chunk = names[start:start + args.batch_size]
        imgs, shapes = zip(*(read_square(os.path.join(orig_root, n),
                                         args.size) for n in chunk))
        sidx = rng.randint(0, len(style_bank), len(chunk))
        out = stylizer(np.stack(imgs),
                       style_bank[torch.from_numpy(sidx).to(dev)],
                       alpha=alpha_val[start:start + len(chunk)])
        out = out.cpu().numpy()
        for i, n in enumerate(chunk):
            stem = os.path.splitext(n)[0]
            a = alpha_val[start + i]
            styled_name = (f"{stem}_alpha_{a:.2f}.jpg"
                           if args.alpha == "random" else f"{stem}.jpg")
            write_resized(os.path.join(out_root, styled_name), out[i],
                          shapes[i])
            mapping[stem] = styled_name
        print(f"{min(start + len(chunk), len(names))}/{len(names)} stylized",
              end="\r")

    dict_dir = os.path.join(data_path, "mapping_dicts")
    os.makedirs(dict_dir, exist_ok=True)
    dict_path = os.path.join(
        dict_dir,
        f"{args.split}_dict_style_{args.styles}_alpha_{args.alpha}.json")
    with open(dict_path, "w") as f:
        json.dump(mapping, f)
    print(f"\nWrote {len(mapping)} mappings to {dict_path}")
    return dict_path


if __name__ == "__main__":
    main()
