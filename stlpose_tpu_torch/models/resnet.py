"""ResNet backbone (NCHW) of the detector: returns C2..C5.

Port of ``stlpose_tpu/models/resnet.py`` (live eval BatchNorm, or
``folded``: ``stem_conv`` with a bias and no ``stem_bn``, every ConvBN
folded). Its bottleneck is HRNet's (same layers, same names). Submodule
names repeat the Flax module tree (``stem_conv``, ``stem_bn``,
``layer{s}_{b}.cb{q}``, ``.down``). The input is cast to the dtype of the
convolutions (``models/hrnet.py::compute_in``), as flax's ``dtype`` does.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch.models.hrnet import Bottleneck


class ResNet(nn.Module):
    """ResNet-{50,101} trunk; forward returns [C2, C3, C4, C5]."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), width: int = 64,
                 folded: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = nn.Conv2d(3, width, 7, 2, 3, bias=folded)
        self.stem_bn = None if folded else nn.BatchNorm2d(width)
        cin, planes = width, width
        for s, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                self.add_module(f"layer{s + 1}_{b}",
                                Bottleneck(cin, planes, stride,
                                           downsample=(b == 0),
                                           folded=folded))
                cin = planes * Bottleneck.expansion
            planes *= 2

    def forward(self, x):
        x = self.stem_conv(x.to(self.stem_conv.weight.dtype))
        if self.stem_bn is not None:
            x = self.stem_bn(x.float()).to(x.dtype)
        x = F.relu(x)
        # implicit -inf padding, as the reference's explicit -inf pad
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for s, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
            feats.append(x)
        return feats
