"""HRNet pose network (W32, 256x192 -> 64x48x17 heatmaps) as nn.Modules.

Port of ``stlpose_tpu/models/hrnet.py`` in eval mode (``model.eval()``,
running statistics) and in train mode (``model.train()``, batch
statistics, with flax's running-statistics update), and in its serving
flavors: ``folded=True`` (BatchNorm folded into the convolutions by
``models/quantize.py::fold_batchnorms``: each ConvBN is a biased conv with
no ``bn`` submodule) and ``dtype=torch.bfloat16`` (compute in bf16 as
flax's ``dtype=bfloat16`` does: conv weights rounded to bf16, ReLU and
residual adds in bf16, live BatchNorm in f32, heatmaps cast to f32 at the
end). Inside, tensors are NCHW; the public forward keeps
the JAX package's layout: (N, 256, 192, 3) NHWC in, (N, 64, 48, J) out
(a permuted view of the NCHW heatmaps, so decode reads them in place).

Submodule names repeat the Flax module tree (``stem1.conv``,
``stage2_m0.branch0_block0.cb1.bn``, ...), so weights carry across by
layout alone (``models/convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import HRNetConfig, HRNetStageConfig, \
    get_hrnet_config


def _upsample_nearest(x, factor: int):
    """Nearest-neighbour 2^k upsample of NCHW by repetition."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode semantics (eps 1e-5, momentum
    0.1): normalise with the batch mean and biased variance, and move the
    running variance toward the *biased* batch variance.
    ``nn.BatchNorm2d`` moves it toward the unbiased one, n/(n-1) larger:
    1.14x at 8 values a channel. Eval mode is ``nn.BatchNorm2d``'s.

    One statistics pass, ``F.batch_norm``'s own: its update gives
    ``rv' = keep*rv + (1-keep)*var*n/(n-1)``; taking back the excess,
    ``rv' - (rv' - keep*rv)/n``, leaves flax's ``keep*rv + (1-keep)*var``."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum                  # flax's momentum, 0.9
        # the op keeps its running_var for backward: hand it a copy
        upd = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, upd, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(keep / n).add_(upd, alpha=1.0 - 1.0 / n)
        return y


def compute_in(module: nn.Module, dtype):
    """Move the convolutions and dense layers of ``module`` to ``dtype``
    (weights rounded once, to nearest even, as flax casts its f32 params at
    each call); BatchNorm layers stay f32."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return module


class ConvBN(nn.Module):
    """conv (no bias, symmetric k//2 padding) + BatchNorm (eps 1e-5, the
    reference's; flax's train-mode update) [+ ReLU]. ``folded``: a biased
    conv and no BatchNorm. The BatchNorm runs in f32 on the conv's output
    and its result returns to the conv's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, folded: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=folded)
        self.bn = None if folded else FlaxBatchNorm2d(cout)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x.float()).to(x.dtype)
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    """Two 3x3 ConvBNs with a residual."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, folded: bool = False):
        super().__init__()
        self.cb1 = ConvBN(cin, features, 3, stride, folded=folded)
        self.cb2 = ConvBN(features, features, 3, 1, relu=False,
                          folded=folded)
        self.down = (ConvBN(cin, features, 1, stride, relu=False,
                            folded=folded) if downsample else None)

    def forward(self, x):
        y = self.cb2(self.cb1(x))
        residual = x if self.down is None else self.down(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) with a residual."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, folded: bool = False):
        super().__init__()
        self.cb1 = ConvBN(cin, features, 1, 1, folded=folded)
        self.cb2 = ConvBN(features, features, 3, stride, folded=folded)
        self.cb3 = ConvBN(features, features * self.expansion, 1, 1,
                          relu=False, folded=folded)
        self.down = (ConvBN(cin, features * self.expansion, 1, stride,
                            relu=False, folded=folded)
                     if downsample else None)

    def forward(self, x):
        y = self.cb3(self.cb2(self.cb1(x)))
        residual = x if self.down is None else self.down(x)
        return F.relu(y + residual)


class HighResolutionModule(nn.Module):
    """Parallel BasicBlock branches + all-to-all cross-resolution fusion."""

    def __init__(self, stage: HRNetStageConfig,
                 multi_scale_output: bool = True, folded: bool = False):
        super().__init__()
        self.stage = stage
        chans = stage.num_channels
        for b in range(stage.num_branches):
            for k in range(stage.num_blocks[b]):
                self.add_module(f"branch{b}_block{k}",
                                BasicBlock(chans[b], chans[b],
                                           folded=folded))
        self.n_out = (stage.num_branches if multi_scale_output else 1) \
            if stage.num_branches > 1 else 0
        for i in range(self.n_out):
            for j in range(stage.num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}",
                                    ConvBN(chans[j], chans[i], 1, 1,
                                           relu=False, folded=folded))
                elif j < i:
                    for k in range(i - j):
                        last = k == i - j - 1
                        self.add_module(
                            f"fuse{i}_{j}_{k}",
                            ConvBN(chans[j], chans[i] if last else chans[j],
                                   3, 2, relu=not last, folded=folded))

    def forward(self, xs):
        st = self.stage
        ys = []
        for b in range(st.num_branches):
            y = xs[b]
            for k in range(st.num_blocks[b]):
                y = getattr(self, f"branch{b}_block{k}")(y)
            ys.append(y)
        if st.num_branches == 1:
            return ys
        fused = []
        for i in range(self.n_out):
            acc = None
            for j in range(st.num_branches):
                if j == i:
                    z = ys[j]
                elif j > i:
                    z = _upsample_nearest(getattr(self, f"fuse{i}_{j}")(ys[j]),
                                          2 ** (j - i))
                else:
                    z = ys[j]
                    for k in range(i - j):
                        z = getattr(self, f"fuse{i}_{j}_{k}")(z)
                acc = z if acc is None else acc + z
            fused.append(F.relu(acc))
        return fused


class PoseHighResolutionNet(nn.Module):
    """HRNet keypoint-heatmap regressor: (N, 256, 192, 3) NHWC ->
    (N, 64, 48, num_joints) heatmaps, float32; built in eval mode.
    ``dtype`` (float32 or bfloat16) is the compute dtype; ``folded``
    takes BatchNorm-folded weights (serving only)."""

    def __init__(self, config: HRNetConfig = get_hrnet_config("w32_256x192"),
                 device="cuda", dtype=torch.float32, folded: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.dtype = dtype
        self.folded = folded
        fo = dict(folded=folded)
        self.stem1 = ConvBN(3, cfg.stem_channels, 3, 2, **fo)
        self.stem2 = ConvBN(cfg.stem_channels, cfg.stem_channels, 3, 2, **fo)
        cin = cfg.stem_channels
        for k in range(cfg.stage1_num_blocks):
            self.add_module(f"layer1_{k}",
                            Bottleneck(cin, cfg.stem_channels,
                                       downsample=(k == 0), **fo))
            cin = cfg.stem_channels * Bottleneck.expansion

        prev = [cin]
        stages = (cfg.stage2, cfg.stage3, cfg.stage4)
        for s, stage in enumerate(stages, start=2):
            for i in range(stage.num_branches):
                if i < len(prev):
                    if prev[i] != stage.num_channels[i]:
                        self.add_module(
                            f"transition{s - 1}_{i}",
                            ConvBN(prev[i], stage.num_channels[i], 3, 1,
                                   **fo))
                else:
                    c = prev[-1]
                    for j in range(i + 1 - len(prev)):
                        out_ch = (stage.num_channels[i]
                                  if j == i - len(prev) else prev[-1])
                        self.add_module(f"transition{s - 1}_{i}_{j}",
                                        ConvBN(c, out_ch, 3, 2, **fo))
                        c = out_ch
            for m in range(stage.num_modules):
                mso = not (s == 4 and m == stage.num_modules - 1)
                self.add_module(f"stage{s}_m{m}",
                                HighResolutionModule(stage, mso, **fo))
            prev = list(stage.num_channels)

        k = cfg.final_conv_kernel
        self.final_layer = nn.Conv2d(cfg.stage4.num_channels[0],
                                     cfg.num_joints, k, 1,
                                     1 if k == 3 else 0)
        compute_in(self.to(device), dtype)
        self.eval()

    def forward(self, x):
        cfg = self.config
        x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        x = self.stem2(self.stem1(x))
        for k in range(cfg.stage1_num_blocks):
            x = getattr(self, f"layer1_{k}")(x)
        xs = [x]
        n_prev = 1
        for s, stage in enumerate((cfg.stage2, cfg.stage3, cfg.stage4),
                                  start=2):
            nxt = []
            for i in range(stage.num_branches):
                if i < n_prev:
                    t = getattr(self, f"transition{s - 1}_{i}", None)
                    nxt.append(xs[i] if t is None else t(xs[i]))
                else:
                    z = xs[-1]
                    for j in range(i + 1 - n_prev):
                        z = getattr(self, f"transition{s - 1}_{i}_{j}")(z)
                    nxt.append(z)
            xs = nxt
            for m in range(stage.num_modules):
                xs = getattr(self, f"stage{s}_m{m}")(xs)
            n_prev = stage.num_branches
        return self.final_layer(xs[0]).float().permute(0, 2, 3, 1)
