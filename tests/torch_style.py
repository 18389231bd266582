"""Seeded style-transfer weights and files shared by the port's style
tests: VGG16 and AdaIN decoder parameters in Flax layout made with numpy
(Flax's eager init is slow), their torchvision state dict, the stylizer
pair built from them, and image folders."""

import os

import numpy as np
import torch

from stlpose_tpu.models import adain as jax_adain
from stlpose_tpu.models import vgg as jax_vgg
from stlpose_tpu_torch.models import adain
from stlpose_tpu_torch.models.convert import (adain_decoder_from_jax,
                                              vgg_from_jax)

ENC_TAPS = (1, 3, 6)
DEC_CHANNELS = ((256, 256), (256, 128), (128, 128), (128, 64), (64, 64),
                (64, 3))


def vgg_params(seed, n_convs=10):
    """Flax-layout VGG16 params (He-scaled HWIO kernels, small biases)."""
    rng = np.random.RandomState(seed)
    params, cin = {}, 3
    for i in range(n_convs):
        c = jax_vgg.VGG16_CHANNELS[i]
        params[f"conv{i}"] = {
            "kernel": (rng.randn(3, 3, cin, c) *
                       np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            "bias": (rng.randn(c) * 0.05).astype(np.float32)}
        cin = c
    return {"params": params}


def decoder_params(seed):
    """Flax-layout AdaIN decoder params (the npz's ``params`` dict)."""
    rng = np.random.RandomState(seed)
    return {f"dec{i}": {
        "kernel": (rng.randn(3, 3, cin, cout) *
                   np.sqrt(1.0 / (9 * cin))).astype(np.float32),
        "bias": (rng.randn(cout) * 0.05).astype(np.float32)}
        for i, (cin, cout) in enumerate(DEC_CHANNELS)}


def torchvision_state(variables):
    """The torchvision ``features.{i}`` state dict of Flax VGG params."""
    return {f"features.{jax_vgg.VGG16_CONV_IDX[int(k[4:])]}.{leaf}":
            torch.from_numpy(np.ascontiguousarray(
                v["kernel"].transpose(3, 2, 0, 1) if leaf == "weight"
                else v["bias"]))
            for k, v in variables["params"].items()
            for leaf in ("weight", "bias")}


def stylizer_pair(enc, dec):
    """(JAX stylizer, port stylizer on the CPU) on the same weights."""
    return (jax_adain.AdaINStylizer(enc_variables=enc,
                                    dec_variables={"params": dec}),
            adain.AdaINStylizer(vgg_from_jax(enc, ENC_TAPS, "cpu"),
                                adain_decoder_from_jax({"params": dec},
                                                       "cpu"),
                                device="cpu"))


def write_weight_files(root, enc, dec):
    """(vgg16 .pth, decoder npz) of the given weights under ``root``."""
    pth = os.path.join(root, "vgg16.pth")
    torch.save(torchvision_state(enc), pth)
    npz = os.path.join(root, "decoder.npz")
    np.savez(npz, params=np.asarray(dec, dtype=object))
    return pth, npz


def write_images(d, rng, n, hw, ext=".png"):
    """``n`` random RGB images of (H, W) = hw, img0..img{n-1}."""
    import cv2

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"img{i}{ext}"),
                    (rng.rand(*hw, 3) * 255).astype(np.uint8))
    return d
