"""HRNet pose network (W32, 256x192 -> 64x48x17 heatmaps) as nn.Modules.

Port of ``stlpose_tpu/models/hrnet.py`` in eval mode (``model.eval()``,
running statistics) and in train mode (``model.train()``, batch
statistics, with flax's running-statistics update), and in its serving
flavors: ``folded=True`` (BatchNorm folded into the convolutions by
``models/quantize.py::fold_batchnorms``: each ConvBN is a biased conv with
no ``bn`` submodule), ``quant`` on a folded graph ("calib" records each
ConvBN input's statistics; "int8" / "int8u" run each ConvBN as w8a8 on
kernels K6q and K6, ``models/quantize.py`` making their weights) and
``dtype=torch.bfloat16`` (compute in bf16 as
flax's ``dtype=bfloat16`` does: convolutions on bf16 weights, ReLU and
residual adds in bf16, live BatchNorm in f32, heatmaps cast to f32 at the
end). With bf16 compute the convolution weights are stored rounded to
bf16 (serving: the values flax's cast gives at every call, with no cast
launched), or, with ``param_dtype=torch.float32`` (training, flax's
``param_dtype``), kept in f32 and cast at each call, so the optimizer
updates f32 master weights and the gradients reach them in f32. Inside,
tensors are NCHW; the public forward keeps
the JAX package's layout: (N, 256, 192, 3) NHWC in, (N, 64, 48, J) out
(a permuted view of the NCHW heatmaps, so decode reads them in place).

Submodule names repeat the Flax module tree (``stem1.conv``,
``stage2_m0.branch0_block0.cb1.bn``, ...), so weights carry across by
layout alone (``models/convert.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.kernels import int8_conv
from stlpose_tpu_torch.parallel.distributed import all_reduce_sum
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
    ``rv' - (rv' - keep*rv)/n``, leaves flax's ``keep*rv + (1-keep)*var``.

    A bf16 input (bf16 compute) is widened to the parameters' f32 first:
    statistics, running statistics and output in f32, as every BatchNorm
    of the JAX package (``nn.BatchNorm(dtype=float32)``) computes them on
    a bf16 convolution's output; the caller rounds the output back to its
    compute dtype after the activation, where the reference does.

    Given a ``process_group`` of more than one rank
    (``set_batchnorm_group``), train mode takes the statistics over the
    group's global batch, as a BatchNorm under GSPMD does over the mesh:
    one all-reduce of the per-channel sums and the count gives the mean,
    a second of the squared deviations from it the biased variance (two
    passes, as here on one rank, summed in f64 as the CPU's
    ``F.batch_norm`` sums), both through ``all_reduce_sum``, whose
    backward sums the ranks' gradients; the running statistics move with
    the global n. Eval mode and one rank are unchanged."""

    process_group = None

    def forward(self, x):
        x = x.to(self.weight.dtype)
        if not self.training:
            return super().forward(x)
        group = self.process_group
        if group is not None and dist.get_world_size(group) > 1:
            return self._global_forward(x, group)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum                  # flax's momentum, 0.9
        # the op keeps its running_var for backward: hand it a copy
        upd = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, upd, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(keep / n).add_(upd, alpha=1.0 - 1.0 / n)
        return y

    def _global_forward(self, x, group):
        dims = (0, 2, 3)
        f64 = torch.float64                 # sums kept as F.batch_norm's
        local_n = torch.full((1,), x.numel() // x.shape[1], dtype=f64,
                             device=x.device)
        sums = all_reduce_sum(torch.cat([x.sum(dims, dtype=f64), local_n]),
                              group)
        n = sums[-1]
        mean = (sums[:-1] / n).to(x.dtype)
        xc = x - mean[None, :, None, None]
        var = (all_reduce_sum(xc.to(f64).square().sum(dims), group) /
               n).to(x.dtype)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = xc * scale[None, :, None, None] + self.bias[None, :, None, None]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
        return y


def set_batchnorm_group(module: nn.Module, group) -> nn.Module:
    """Take every ``FlaxBatchNorm2d`` of ``module``'s train-mode statistics
    over ``group`` (None: this rank's batch alone)."""
    for m in module.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.process_group = group
    return module


def compute_in(module: nn.Module, dtype, param_dtype=None):
    """Make ``dtype`` the compute dtype of the convolutions and dense
    layers of ``module`` (flax's ``dtype``) and store their weights in
    ``param_dtype`` (flax's ``param_dtype``; None: ``dtype``, the weights
    rounded once, to nearest even, to the values flax's cast gives at each
    call). BatchNorm layers stay f32."""
    stored = param_dtype or dtype
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(stored)
            m.compute_dtype = None if stored == dtype else dtype
    return module


class CastParams:
    """The port's convolutions and dense layers compute in their
    ``compute_dtype``, as a flax layer computes in its ``dtype``: the
    input is cast to it, and weights stored in another dtype (f32 master
    weights under bf16 compute) are cast at each call, so that their
    gradients reach the stored weights in f32. ``compute_in`` sets it
    where the weights are stored in another dtype; None computes in the
    weights' own dtype (so a module moved with ``.double()`` computes in
    float64)."""
    compute_dtype = None

    def cast(self, x):
        """(input, weight, bias) in the compute dtype."""
        dt = self.compute_dtype or self.weight.dtype
        w, b = self.weight, self.bias
        if w.dtype != dt:
            w = w.to(dt)
            b = None if b is None else b.to(dt)
        return x.to(dt), w, b


class Conv2d(CastParams, nn.Conv2d):
    """``nn.Conv2d`` in its compute dtype (``CastParams``)."""

    def forward(self, x):
        return self._conv_forward(*self.cast(x))


class Linear(CastParams, nn.Linear):
    """``nn.Linear`` in its compute dtype (``CastParams``)."""

    def forward(self, x):
        return F.linear(*self.cast(x))


QUANT_MODES = ("none", "calib", "int8", "int8u")
INT8_MODES = ("int8", "int8u")
# the quantile of |x| that calibration records beside its max
CALIB_QUANTILE = 0.999


def quantile_linear(a, q: float):
    """``jnp.quantile(a, q)`` (method "linear") of a flat f32 tensor, as
    the JAX package computes it: the index ``q * (n - 1)`` in f32 (n
    rounded to f32 first), its floor and ceiling as the two neighbours,
    weights ``1 - frac`` and ``frac`` in f32; NaN if ``a`` holds a NaN.
    The neighbours come from one ``topk`` of the largest ``n - floor``
    values (``torch.quantile`` refuses more than 2^24 elements)."""
    n = a.numel()
    nf = np.float32(n)
    qf = np.float32(q) * (nf - np.float32(1.0))
    low, high = np.floor(qf), np.ceil(qf)
    hw = np.float32(qf - low)
    lw = np.float32(np.float32(1.0) - hw)
    # XLA's gather clamps an index past the end (nf - 1 may round up)
    low = min(int(min(max(low, 0.0), nf - 1)), n - 1)
    high = min(int(min(max(high, 0.0), nf - 1)), n - 1)
    top = torch.topk(a, n - low, sorted=True).values  # descending
    out = top[n - 1 - low] * float(lw) + top[n - 1 - high] * float(hw)
    return torch.where(torch.isnan(a).any(), float("nan"), out)


class ConvBN(nn.Module):
    """conv (no bias, symmetric k//2 padding) + BatchNorm (eps 1e-5, the
    reference's; flax's train-mode update) [+ ReLU]. ``folded``: a biased
    conv and no BatchNorm. The BatchNorm runs in f32 on the conv's output
    and its result returns to the conv's dtype.

    ``quant`` (folded graphs only) is the int8 post-training quantization
    mode of ``stlpose_tpu/models/hrnet.py::ConvBN``:

    * "calib": the folded conv, and its input's ``in_absmax`` (max |x|),
      ``in_q999`` (the 0.999 quantile of |x|) and ``in_min`` (min x) kept
      in ``calib_stats`` as f32 device scalars, max- (min-) reduced over
      calls from 0 (+inf) until ``calib_stats`` is set to None;
    * "int8": the input quantized per tensor, ``clip(rint(x / sx), -127,
      127)`` (K6q), the int8 convolution with int32 accumulation, then
      ``acc * (sx * sw) + bias`` (K6), ReLU, the input's dtype;
    * "int8u": ``clip(rint(x / sx), qlo, qhi) - zp`` and padding with -zp
      (the ``zp * sum(w8)`` term is folded into ``bias`` by
      ``models/quantize.py::quantize_hrnet``).

    The int8 modes hold buffers, not a conv: ``kernel_i8`` (int8, in K6's
    (C_out, Kpad) layout), ``sw`` (C_out,), ``sx`` (), ``bias`` (C_out,)
    and, for "int8u", ``zp``, ``qlo``, ``qhi`` (), all f32 but the
    kernel, named as the Flax scope names its parameters. Their forward is
    ``quantize`` (K6q) then ``conv_codes`` (K6); ``forward(x, codes)``
    takes codes of ``x`` already made (``shared_codes``). ``share_key``
    is (quant, sx[, zp, qlo, qhi]) as host floats, read when the module is
    built and at every ``load_state_dict``: two ConvBNs with equal keys
    code an input to the same bits. None outside the int8 modes."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, folded: bool = False,
                 quant: str = "none"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant {quant!r}; one of {QUANT_MODES}")
        if quant != "none" and not folded:
            raise ValueError(f"quant={quant!r} runs on a folded graph "
                             "(folded=True)")
        self.kernel, self.stride = kernel, stride
        self.relu = relu
        self.quant = quant
        self.calib_stats = None
        self.share_key = None
        if quant in INT8_MODES:
            self.conv = self.bn = None
            self.register_buffer("kernel_i8", torch.zeros(
                (cout, int8_conv.padded_k(kernel, cin)), dtype=torch.int8))
            self.register_buffer("sw", torch.ones(cout))
            self.register_buffer("sx", torch.ones(()))
            self.register_buffer("bias", torch.zeros(cout))
            if quant == "int8u":
                self.register_buffer("zp", torch.zeros(()))
                self.register_buffer("qlo", torch.full((), -127.0))
                self.register_buffer("qhi", torch.full((), 127.0))
            self.share_key = self._scale_key()
            return
        self.conv = Conv2d(cin, cout, kernel, stride, kernel // 2,
                           bias=folded)
        self.bn = None if folded else FlaxBatchNorm2d(cout)

    def _scale_key(self):
        names = ("sx", "zp", "qlo", "qhi") if self.quant == "int8u" \
            else ("sx",)
        return (self.quant, *torch.stack(
            [getattr(self, n).float() for n in names]).tolist())

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        if self.quant in INT8_MODES:
            self.share_key = self._scale_key()

    def _zero_point(self):
        return ((self.zp, self.qlo, self.qhi) if self.quant == "int8u"
                else (None, None, None))

    def quantize(self, x):
        """K6q: the int8 NHWC codes of the NCHW input ``x``."""
        return int8_conv.quantize_activations(x, self.sx,
                                              *self._zero_point())

    def conv_codes(self, xq, dtype):
        """K6 on the codes ``xq``: the output in ``dtype``, NCHW."""
        return int8_conv.int8_conv(xq, self.kernel_i8, self.kernel,
                                   self.stride, self.sx, self.sw, self.bias,
                                   self._zero_point()[0], self.relu, dtype)

    def _record(self, x):
        ax = x.abs().float().flatten()
        new = {"in_absmax": ax.max(),
               "in_q999": quantile_linear(ax, CALIB_QUANTILE),
               "in_min": x.float().min()}
        old = self.calib_stats or {
            "in_absmax": torch.zeros((), device=x.device),
            "in_q999": torch.zeros((), device=x.device),
            "in_min": torch.full((), float("inf"), device=x.device)}
        self.calib_stats = {
            k: (torch.minimum if k == "in_min" else torch.maximum)(old[k], v)
            for k, v in new.items()}

    def forward(self, x, codes=None):
        if self.quant in INT8_MODES:
            return self.conv_codes(self.quantize(x) if codes is None
                                   else codes, x.dtype)
        if self.quant == "calib":
            self._record(x)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x).to(x.dtype)
        return F.relu(x) if self.relu else x


def shared_codes(x, convbns):
    """For each of ``convbns`` (ConvBNs or None) that reads ``x``: the
    codes it should take, made once per ``share_key`` that two or more of
    them hold (one K6q launch for the group); None where a ConvBN
    quantizes ``x`` itself (a key of its own, or not int8)."""
    keys = [None if cb is None else cb.share_key for cb in convbns]
    made = {}
    out = []
    for cb, key in zip(convbns, keys):
        if key is None or keys.count(key) < 2:
            out.append(None)
            continue
        if key not in made:
            made[key] = cb.quantize(x)
        out.append(made[key])
    return out


def int8_quantizations(model: nn.Module) -> int:
    """K6q launches in one forward of ``model``: its int8 ConvBNs less the
    ones whose codes ``shared_codes`` hands on (over every module's
    ``share_sites()``)."""
    n = sum(1 for m in model.modules()
            if isinstance(m, ConvBN) and m.share_key is not None)
    for m in model.modules():
        for site in getattr(m, "share_sites", lambda: ())():
            keys = [cb.share_key for cb in site
                    if cb is not None and cb.share_key is not None]
            n -= len(keys) - len(set(keys))
    return n


class BasicBlock(nn.Module):
    """Two 3x3 ConvBNs with a residual."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, folded: bool = False,
                 quant: str = "none"):
        super().__init__()
        fq = dict(folded=folded, quant=quant)
        self.cb1 = ConvBN(cin, features, 3, stride, **fq)
        self.cb2 = ConvBN(features, features, 3, 1, relu=False, **fq)
        self.down = (ConvBN(cin, features, 1, stride, relu=False, **fq)
                     if downsample else None)

    def share_sites(self):
        """The groups of ConvBNs that read one tensor: ``cb1`` and
        ``down`` read the block's input."""
        return ([self.cb1, self.down],)

    def forward(self, x):
        q1, qd = shared_codes(x, *self.share_sites())
        y = self.cb2(self.cb1(x, q1))
        residual = x if self.down is None else self.down(x, qd)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) with a residual."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, folded: bool = False,
                 quant: str = "none"):
        super().__init__()
        fq = dict(folded=folded, quant=quant)
        self.cb1 = ConvBN(cin, features, 1, 1, **fq)
        self.cb2 = ConvBN(features, features, 3, stride, **fq)
        self.cb3 = ConvBN(features, features * self.expansion, 1, 1,
                          relu=False, **fq)
        self.down = (ConvBN(cin, features * self.expansion, 1, stride,
                            relu=False, **fq)
                     if downsample else None)

    def share_sites(self):
        """``cb1`` and ``down`` read the block's input."""
        return ([self.cb1, self.down],)

    def forward(self, x):
        q1, qd = shared_codes(x, *self.share_sites())
        y = self.cb3(self.cb2(self.cb1(x, q1)))
        residual = x if self.down is None else self.down(x, qd)
        return F.relu(y + residual)


class HighResolutionModule(nn.Module):
    """Parallel BasicBlock branches + all-to-all cross-resolution fusion."""

    def __init__(self, stage: HRNetStageConfig,
                 multi_scale_output: bool = True, folded: bool = False,
                 quant: str = "none"):
        super().__init__()
        self.stage = stage
        chans = stage.num_channels
        fq = dict(folded=folded, quant=quant)
        for b in range(stage.num_branches):
            for k in range(stage.num_blocks[b]):
                self.add_module(f"branch{b}_block{k}",
                                BasicBlock(chans[b], chans[b], **fq))
        self.n_out = (stage.num_branches if multi_scale_output else 1) \
            if stage.num_branches > 1 else 0
        for i in range(self.n_out):
            for j in range(stage.num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}",
                                    ConvBN(chans[j], chans[i], 1, 1,
                                           relu=False, **fq))
                elif j < i:
                    for k in range(i - j):
                        last = k == i - j - 1
                        self.add_module(
                            f"fuse{i}_{j}_{k}",
                            ConvBN(chans[j], chans[i] if last else chans[j],
                                   3, 2, relu=not last, **fq))

    def _readers(self, j):
        """The fuse ConvBNs that read branch ``j``'s output: ``fuse{i}_{j}``
        (i < j) and the first of each chain ``fuse{i}_{j}_0`` (i > j)."""
        return [getattr(self, f"fuse{i}_{j}" if j > i else f"fuse{i}_{j}_0")
                for i in range(self.n_out) if i != j]

    def share_sites(self):
        return tuple(self._readers(j)
                     for j in range(self.stage.num_branches)) \
            if self.n_out else ()

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
        codes = {}
        for j in range(st.num_branches):
            readers = self._readers(j)
            codes.update(zip(map(id, readers), shared_codes(ys[j], readers)))
        fused = []
        for i in range(self.n_out):
            acc = None
            for j in range(st.num_branches):
                if j == i:
                    z = ys[j]
                elif j > i:
                    cb = getattr(self, f"fuse{i}_{j}")
                    z = _upsample_nearest(cb(ys[j], codes[id(cb)]),
                                          2 ** (j - i))
                else:
                    cb = getattr(self, f"fuse{i}_{j}_0")
                    z = cb(ys[j], codes[id(cb)])
                    for k in range(1, i - j):
                        z = getattr(self, f"fuse{i}_{j}_{k}")(z)
                acc = z if acc is None else acc + z
            fused.append(F.relu(acc))
        return fused


class PoseHighResolutionNet(nn.Module):
    """HRNet keypoint-heatmap regressor: (N, 256, 192, 3) NHWC ->
    (N, 64, 48, num_joints) heatmaps, float32; built in eval mode.
    ``dtype`` (float32 or bfloat16) is the compute dtype; ``param_dtype``
    the storage of the convolution weights (None: ``dtype``; float32 for
    training); ``folded`` takes BatchNorm-folded weights (serving only);
    ``quant`` is every ConvBN's int8 mode ("none", "calib", "int8",
    "int8u"; folded only), ``final_layer`` staying a float conv."""

    def __init__(self, config: HRNetConfig = get_hrnet_config("w32_256x192"),
                 device="cuda", dtype=torch.float32, folded: bool = False,
                 param_dtype=None, quant: str = "none"):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.dtype = dtype
        self.folded = folded
        self.quant = quant
        fo = dict(folded=folded, quant=quant)
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
        self.final_layer = Conv2d(cfg.stage4.num_channels[0],
                                  cfg.num_joints, k, 1, 1 if k == 3 else 0)
        compute_in(self.to(device), dtype, param_dtype)
        self.eval()

    def _last_readers(self, s, n_prev, num_branches):
        """The transition ConvBNs of stage ``s`` that read the last branch
        of the stage before: ``transition{s-1}_{n_prev-1}`` (None where the
        widths match) and ``transition{s-1}_{i}_0`` of each new branch."""
        return [getattr(self, f"transition{s - 1}_{n_prev - 1}", None)] + [
            getattr(self, f"transition{s - 1}_{i}_0")
            for i in range(n_prev, num_branches)]

    def share_sites(self):
        cfg = self.config
        sites, n_prev = [], 1
        for s, stage in enumerate((cfg.stage2, cfg.stage3, cfg.stage4),
                                  start=2):
            sites.append(self._last_readers(s, n_prev, stage.num_branches))
            n_prev = stage.num_branches
        return tuple(sites)

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
            readers = self._last_readers(s, n_prev, stage.num_branches)
            codes = shared_codes(xs[-1], readers)
            nxt = []
            for i in range(stage.num_branches):
                if i < n_prev:
                    t = getattr(self, f"transition{s - 1}_{i}", None)
                    q = codes[0] if i == n_prev - 1 else None
                    nxt.append(xs[i] if t is None else t(xs[i], q))
                else:
                    z = getattr(self, f"transition{s - 1}_{i}_0")(
                        xs[-1], codes[1 + i - n_prev])
                    for j in range(1, i + 1 - n_prev):
                        z = getattr(self, f"transition{s - 1}_{i}_{j}")(z)
                    nxt.append(z)
            xs = nxt
            for m in range(stage.num_modules):
                xs = getattr(self, f"stage{s}_m{m}")(xs)
            n_prev = stage.num_branches
        return self.final_layer(xs[0]).float().permute(0, 2, 3, 1)


def create_hrnet(config_name: str = "w32_256x192", device="cuda",
                 dtype=torch.float32, folded: bool = False,
                 quant: str = "none") -> PoseHighResolutionNet:
    """``PoseHighResolutionNet`` of a named config (``get_hrnet_config``)
    in a serving flavor."""
    return PoseHighResolutionNet(get_hrnet_config(config_name), device,
                                 dtype, folded, quant=quant)


def fold_input_normalization(state_dict, mean, std):
    """Fold the input normalization ``(x - mean) / std`` (per channel) into
    ``stem1``'s conv and BatchNorm of an unfolded state dict, so the model
    takes raw images: the kernel is divided by ``std`` per input channel
    and the running mean lowered by ``sum_hwi W * mean / std``; in f32
    numpy, in the JAX package's HWIO layout and order (own copy of
    ``stlpose_tpu/models/hrnet.py::fold_input_normalization``). With zero
    padding the constant term is smaller on the stem's 1-pixel border, so
    the folded model differs from the normalized one at crop edges."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    w = state_dict["stem1.conv.weight"]
    W = np.ascontiguousarray(w.detach().cpu().numpy().transpose(
        2, 3, 1, 0))                                          # HWIO
    W_scaled = W / std[None, None, :, None]
    shift = (W * (mean / std)[None, None, :, None]).sum(axis=(0, 1, 2))
    out = dict(state_dict)
    out["stem1.conv.weight"] = torch.from_numpy(
        np.ascontiguousarray(W_scaled.transpose(3, 2, 0, 1))).to(w.device)
    rm = state_dict["stem1.bn.running_mean"]
    out["stem1.bn.running_mean"] = torch.from_numpy(
        rm.detach().cpu().numpy() - shift).to(rm.device)
    return out
