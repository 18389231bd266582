"""EfficientNet backbone (NCHW nn.Modules) for EfficientDet.

Port of ``stlpose_tpu/models/efficientnet.py``: MBConv inverted
bottlenecks with squeeze-excitation and swish, the compound width/depth
scaling of the b0/b3 variants, returning C3, C4 and C5 (strides 8, 16,
32). Submodule names repeat the Flax module tree (``stem_conv``,
``stem_bn``, ``block{i}.expand_conv``, ``block{i}.bn0``, ``dw_conv``,
``se_reduce``, ...), so weights carry across by layout alone
(``models/convert.py::efficientdet_from_jax``).

Two points where the JAX layers differ from PyTorch's defaults:

  * Flax's ``padding="SAME"`` is TensorFlow's: ``ceil(n / s)`` outputs,
    the padding split with the odd pixel after. At stride 2 on an even
    extent that is 0 before and 1 after for k = 3, 1 and 2 for k = 5.
    ``pad_same`` pads explicitly before every convolution and pool
    (PyTorch's ``padding="same"`` refuses stride 2, and symmetric padding
    would shift every tap by one pixel).
  * Every BatchNorm here is flax's with momentum 0.99 and eps 1e-3:
    ``FlaxBatchNorm2d(c, eps=1e-3, momentum=0.01)``.

``Conv2d`` computes in its weights' dtype, casting its input, as a Flax
``nn.Conv(dtype=...)`` does: the bf16 serving flavor stores the
convolutions in bf16 (``models/hrnet.py::compute_in``) and keeps
BatchNorm and swish in f32, each block's output cast back to bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch.models.hrnet import FlaxBatchNorm2d

# (expand_ratio, channels, repeats, stride, kernel)
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def pad_same(x, kernel: int, stride: int, value: float = 0.0):
    """TF-SAME padding of an NCHW map for a ``kernel`` x ``kernel`` window
    at ``stride``: ``ceil(n / stride)`` outputs per axis, the odd pixel of
    the padding after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):              # F.pad: last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


def max_pool_same(x):
    """Flax's ``max_pool(x, (3, 3), (2, 2), "SAME")``: padding with -inf."""
    return F.max_pool2d(pad_same(x, 3, 2, float("-inf")), 3, 2)


def bn(channels: int) -> FlaxBatchNorm2d:
    """A BatchNorm with flax's momentum 0.99 (torch's 0.01) and eps 1e-3."""
    return FlaxBatchNorm2d(channels, eps=1e-3, momentum=0.01)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with TF-SAME padding, computing in its weights'
    dtype (its input is cast to it)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(cin, cout, kernel, stride, 0, groups=groups,
                         bias=bias)

    def forward(self, x):
        x = pad_same(x.to(self.weight.dtype), self.kernel_size[0],
                     self.stride[0])
        return self._conv_forward(x, self.weight, self.bias)


def batch_norm(norm, x):
    """BatchNorm in its parameters' dtype on a conv output: f32 (flax's
    ``dtype=float32``) also under bf16 compute."""
    return norm(x.to(norm.weight.dtype))


class MBConv(nn.Module):
    """Inverted bottleneck: expand 1x1 -> depthwise kxk -> SE -> project."""

    def __init__(self, cin: int, cout: int, expand: int, stride: int,
                 kernel: int, se_ratio: float = 0.25):
        super().__init__()
        mid = cin * expand
        self.residual = stride == 1 and cin == cout
        if expand != 1:
            self.expand_conv = Conv2d(cin, mid, 1, bias=False)
            self.bn0 = bn(mid)
        else:
            self.expand_conv = None
        self.dw_conv = Conv2d(mid, mid, kernel, stride, groups=mid,
                              bias=False)
        self.bn1 = bn(mid)
        se_ch = max(1, int(cin * se_ratio))
        self.se_reduce = Conv2d(mid, se_ch, 1)
        self.se_expand = Conv2d(se_ch, mid, 1)
        self.project_conv = Conv2d(mid, cout, 1, bias=False)
        self.bn2 = bn(cout)

    def forward(self, x):
        dt = self.dw_conv.weight.dtype
        h = x
        if self.expand_conv is not None:
            h = F.silu(batch_norm(self.bn0, self.expand_conv(h))).to(dt)
        h = F.silu(batch_norm(self.bn1, self.dw_conv(h))).to(dt)
        # squeeze & excitation
        se = h.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(se))))
        h = self.project_conv(h * se)
        h = batch_norm(self.bn2, h).to(dt)
        if self.residual:
            h = h + x
        return h


class EfficientNet(nn.Module):
    """Backbone trunk: NCHW images -> [C3 (stride 8), C4 (stride 16), C5
    (stride 32)]."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0):
        super().__init__()
        stem_ch = round_filters(32, width_mult)
        self.stem_conv = Conv2d(3, stem_ch, 3, 2, bias=False)
        self.stem_bn = bn(stem_ch)
        cin, bi = stem_ch, 0
        self.taps = []              # index of the block ending stages 2, 4, 6
        for si, (expand, ch, reps, stride, kernel) in enumerate(B0_BLOCKS):
            cout = round_filters(ch, width_mult)
            for r in range(round_repeats(reps, depth_mult)):
                self.add_module(f"block{bi}", MBConv(
                    cin, cout, expand, stride if r == 0 else 1, kernel))
                cin = cout
                bi += 1
            if si in (2, 4, 6):
                self.taps.append(bi - 1)
        self.n_blocks = bi
        self.out_channels = [getattr(self, f"block{i}").bn2.num_features
                             for i in self.taps]

    def forward(self, x):
        dt = self.stem_conv.weight.dtype
        x = F.silu(batch_norm(self.stem_bn, self.stem_conv(x))).to(dt)
        feats = []
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
            if i in self.taps:
                feats.append(x)
        return feats
