"""Model FLOP counter: 2 x the multiply-adds of every convolution and
dense layer, counted by ``torch.utils.flop_counter`` while the plain
reference's forward runs on shape-only ("meta") tensors at the
configuration's shapes. Normalisation, activations, pooling, sampling
and suppression are not counted."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import models


def _meta(W):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in W.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def hrnet_flops(W, pcfg, height: int = 256, width: int = 192) -> int:
    """One HRNet forward of one crop."""
    Wm = _meta(W)
    x = torch.empty((1, height, width, 3), device="meta")
    return _count(lambda: models.hrnet(Wm, pcfg, x))


def resnet_flops(W, dcfg, size: int) -> int:
    """The ResNet trunk alone on one size x size image."""
    Wm = _meta(W)
    x = torch.empty((1, 3, size, size), device="meta")
    return _count(lambda: models.resnet(Wm, dcfg, x))


def trunk_flops(W, dcfg, size: int) -> int:
    """The ResNet trunk, FPN and RPN head on one size x size image."""
    Wm = _meta(W)
    x = torch.empty((1, 3, size, size), device="meta")
    return _count(lambda: models.rpn_head(Wm, models.features(Wm, dcfg, x)))


def detector_flops(W, dcfg) -> int:
    """One image through trunk, FPN, RPN head and the box head on every
    test-time proposal."""
    Wm = _meta(W)
    c = W["fpn.out0.weight"].shape[0]
    pooled = torch.empty((dcfg["post_nms_top_n_test"], 7, 7, c),
                         device="meta")
    return trunk_flops(W, dcfg, dcfg["image_size"]) + _count(
        lambda: models.box_head(Wm, pooled))
