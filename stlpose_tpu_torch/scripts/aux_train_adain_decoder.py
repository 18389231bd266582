#!/usr/bin/env python
"""Train the AdaIN decoder over a content and a style image directory.

    python stlpose_tpu_torch/scripts/aux_train_adain_decoder.py
        --content_dir <coco>/train2017 --style_dir <vase crops>
        --out decoder_adain.npz [--steps 20000] [--batch_size 8]
        [--size 256] [--vgg_weights vgg16-torchvision.pth]
        [--device cuda|cpu]

Counterpart of ``scripts/aux_train_adain_decoder.py``: each step draws a
batch of content and a batch of style images (numpy ``RandomState`` of
``--seed``, in the JAX script's order), resizes each so its short side
is ``--size`` and takes a random square crop, then takes one Adam step
of ``models/adain.py::train_adain_decoder`` (encoder frozen: the
torchvision VGG16 of ``--vgg_weights``, or seeded random features). The
decoder is written in the JAX package's npz format, which
``aux_styled_coco_preload.py --decoder_ckpt`` and
``dataset.inline_style.decoder_ckpt`` read in either package.
"""

import argparse
import os
import sys

import numpy as np

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from stlpose_tpu_torch import resolve_device  # noqa: E402
from stlpose_tpu_torch.models.adain import (AdaINStylizer,  # noqa: E402
                                            load_vgg_encoder,
                                            save_decoder_npz,
                                            train_adain_decoder)


def read_short_side(path: str, size: int) -> np.ndarray:
    """The RGB image at ``path`` (uint8, through cv2) resized so that its
    short side is ``size`` and neither side is shorter."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    h, w = img.shape[:2]
    scale = max(size / h, size / w)
    return cv2.resize(img, (max(size, int(round(w * scale))),
                            max(size, int(round(h * scale)))))


def list_images(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))]


def main(argv=None):
    """Returns the per-step losses."""
    p = argparse.ArgumentParser()
    p.add_argument("--content_dir", required=True)
    p.add_argument("--style_dir", required=True)
    p.add_argument("--out", required=True, help="output npz path")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--size", type=int, default=256,
                   help="training crop size (square)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--style_weight", type=float, default=10.0)
    p.add_argument("--recon_weight", type=float, default=1.0)
    p.add_argument("--vgg_weights", default=None,
                   help="torchvision vgg16 .pth for the frozen encoder")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless cpu is asked for)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    encoder = (load_vgg_encoder(args.vgg_weights, dev) if args.vgg_weights
               else None)
    stylizer = AdaINStylizer(encoder, device=dev,
                             generator=torch.Generator().manual_seed(
                                 args.seed))

    content_files = list_images(args.content_dir)
    style_files = list_images(args.style_dir)
    if not content_files or not style_files:
        raise FileNotFoundError(f"no images in {args.content_dir} or "
                                f"{args.style_dir}")
    rng = np.random.RandomState(args.seed)
    S = args.size

    def read_crop(path):
        img = read_short_side(path, S)
        y = rng.randint(0, img.shape[0] - S + 1)
        x = rng.randint(0, img.shape[1] - S + 1)
        return img[y:y + S, x:x + S].astype(np.float32) / 255.0

    def batches():
        for _ in range(args.steps):
            content = np.stack([read_crop(content_files[i]) for i in
                                rng.randint(0, len(content_files),
                                            args.batch_size)])
            style = np.stack([read_crop(style_files[i]) for i in
                              rng.randint(0, len(style_files),
                                          args.batch_size)])
            yield content, style

    recent = []

    def log(step, loss):
        recent.append(loss)
        if step % args.log_every == 0:
            print(f"step {step}/{args.steps} loss {np.mean(recent):.4f}",
                  flush=True)
            recent.clear()

    decoder, hist = train_adain_decoder(
        stylizer.encoder, stylizer.decoder, batches(), lr=args.lr,
        style_weight=args.style_weight, recon_weight=args.recon_weight,
        callback=log)
    save_decoder_npz(args.out, decoder)
    print(f"saved decoder to {args.out} "
          f"(final loss {hist[-1]:.4f}, {len(hist)} steps)")
    return hist


if __name__ == "__main__":
    main()
