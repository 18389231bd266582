"""VGG16 feature extractor and the perceptual loss.

Port of ``stlpose_tpu/models/vgg.py``: the VGG16 convolutional trunk up to
a chosen ReLU, its torchvision ``features.{i}`` state-dict loader, and the
perceptual loss (grey-to-RGB repeat, ImageNet normalisation, antialiased
bilinear resize to 224x224, mean L1 distance summed over the taps), which
scores Styled-COCO samples (``scripts/aux_create_offline_perceptual_loss.py``)
and is the AdaIN stylizer's encoder (``models/adain.py``).

NHWC at the boundary, as the JAX package; NCHW inside (``features``).
The ImageNet constants are ``config.py``'s.
Convolutions are named ``conv0``, ``conv1``, ... as the Flax module's, so
Flax variables load by layout alone (``models/convert.py::vgg_from_jax``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

# torchvision vgg16.features: index of each conv, and its out_channels
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                  512)
# 2x2 max-pool after these convs (0-based), except after the last one run
_POOL_AFTER = {1, 3, 6, 9, 12}


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """Flax's default kernel init (variance 1/fan_in, truncated at two
    standard deviations) drawn from ``generator`` on the CPU, then copied
    into ``weight``; the same seed gives the same weights on any
    device."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    lo = math.erf(-2.0 / math.sqrt(2.0))
    w = torch.empty(weight.shape).uniform_(lo, -lo, generator=generator)
    w = w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
    with torch.no_grad():
        weight.copy_(w)


def init_convs(module: nn.Module, generator: torch.Generator | None):
    """Every ``Conv2d`` of ``module``: Flax's init (``_lecun_normal_``,
    zero bias) from ``generator`` (seed 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)


class VGG16Features(nn.Module):
    """VGG16 trunk: the post-ReLU activations after the convs in ``taps``
    (0-based; the default (1, 3, 6, 9) is relu1_2, relu2_2, relu3_3 and
    relu4_3, torchvision's ``features[:4]``, ``[4:9]``, ``[9:16]`` and
    ``[16:23]``). Runs convs 0..max(taps), pooling after convs 1, 3, 6, 9
    and 12 except after the last one it runs."""

    def __init__(self, taps: Sequence[int] = (1, 3, 6, 9), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.taps = tuple(taps)
        cin = 3
        for i in range(max(self.taps) + 1):
            self.add_module(f"conv{i}", nn.Conv2d(cin, VGG16_CHANNELS[i], 3,
                                                  padding=1))
            cin = VGG16_CHANNELS[i]
        init_convs(self, generator)
        self.to(resolve_device(device))

    def features(self, x):
        """NCHW in, list of NCHW taps out."""
        outs = []
        n_convs = max(self.taps) + 1
        for i in range(n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if i in self.taps:
                outs.append(x)
            if i in _POOL_AFTER and i != n_convs - 1:
                x = F.max_pool2d(x, 2, 2)
        return outs

    def forward(self, x):
        """NHWC in, list of NHWC taps out (permuted views)."""
        return [t.permute(0, 2, 3, 1)
                for t in self.features(x.permute(0, 3, 1, 2))]


def vgg16_from_torchvision(state: dict, taps: Sequence[int] = (1, 3, 6, 9),
                           device="cuda") -> VGG16Features:
    """A torchvision vgg16 state dict (``features.{i}.weight``/``bias``,
    tensors or numpy arrays; other keys ignored) -> ``VGG16Features`` to
    ``max(taps)``. Counterpart of ``torch_vgg16_to_flax``; torchvision's
    OIHW kernels are ``Conv2d``'s own layout."""
    vgg = VGG16Features(taps, device=device)
    sd = {}
    for ci in range(max(vgg.taps) + 1):
        ti = VGG16_CONV_IDX[ci]
        for leaf in ("weight", "bias"):
            sd[f"conv{ci}.{leaf}"] = torch.as_tensor(
                state[f"features.{ti}.{leaf}"], dtype=torch.float32)
    vgg.load_state_dict(sd)
    return vgg


def imagenet_normalise(x):
    """NCHW images in [0, 1] -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def resize_bilinear(x, hw):
    """NCHW -> (N, C, H, W) = hw, bilinear with half-pixel centres,
    antialiased when it shrinks (``jax.image.resize``'s "bilinear")."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def make_perceptual_loss_fn(vgg: VGG16Features, resize: bool = True,
                            per_sample: bool = True):
    """fn(input, target): NHWC images in [0, 1] (one channel is repeated
    to three) -> the L1 feature distance summed over the taps, per sample
    (N,) or, with ``per_sample=False``, over the batch (a scalar), with
    the images resized to 224x224 first unless ``resize`` is False."""

    def prepare(x):
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] != 3:
            x = x.repeat(1, 3, 1, 1)
        x = imagenet_normalise(x)
        return resize_bilinear(x, (224, 224)) if resize else x

    def fn(inp, tgt):
        loss = 0.0
        for fi, ft in zip(vgg.features(prepare(inp)),
                          vgg.features(prepare(tgt))):
            diff = (fi - ft).abs()
            loss = loss + (diff.mean(dim=(1, 2, 3)) if per_sample
                           else diff.mean())
        return loss

    return fn
