"""K6: the int8 x int8 -> int32 convolution with its dequantize epilogue,
and K6q: the per-tensor activation quantizer in front of it (CUDA kernels
in ``csrc/int8_conv.cu``).

No Pallas original: they replace the int8 serving path of
``stlpose_tpu/models/hrnet.py::ConvBN`` (``quant="int8"`` and
``"int8u"``, hrnet.py:94-137), which XLA runs as ``conv_general_dilated``
on int8 operands with ``preferred_element_type=int32``. PyTorch on CUDA
has no int8 x int8 -> int32 convolution, and an f32 convolution of the
integer codes is not exact once an accumulator passes 2^24.

K6q (``quantize_activations``) turns the convolution's NCHW f32 or bf16
input into int8 NHWC codes, ``clip(rint(x / sx), lo, hi) - zp`` (a true
f32 division, round half to even; "int8": lo -127, hi 127, zp 0). K6
(``int8_conv``) is an implicit GEMM over those codes and the weights
re-laid at quantize time as int8 (C_out, Kpad): (C_out, kh, kw, C_in)
flattened, K padded with zero weights to a multiple of 32
(``relayout_kernel_i8``). Taps outside the image read 0 ("int8") or -zp
("int8u"). The epilogue is ``acc_f32 * (sx * sw) + bias`` (the product
``sx * sw`` rounded first), then optional ReLU, then the output dtype,
written NCHW. Kernels 1 and 3, ``pad = k // 2``, strides 1 and 2. The
scales (``sx``, ``zp``, ``qlo``, ``qhi``) are 0-d f32 tensors on the
device: the kernels read them there, so a forward needs no host sync.

Each has two kernels (``csrc/int8_conv.cu`` says how each works): K6 runs
``wgmma`` on a TMA / ``cp.async`` ring for C_in % 16 == 0 and the first
design's ``mma.sync`` kernel otherwise (HRNet's 3-channel stem); K6q stores 16
channel bytes a thread for C % 16 == 0 and bytes otherwise.
``LAUNCHES_BY_KERNEL`` and ``QUANTIZE_LAUNCHES_BY_KERNEL`` count each.

Each wrapper calls its operator (``stlpose::int8_conv``,
``stlpose::quantize_activations``; ``kernels/_ops.py``). On CPU tensors
the operator runs the plain version: the same formula in
torch ops for K6q; for K6, ``F.conv2d`` in float64 on the integer codes
(exact: every partial sum is an integer below 2^53), cast to int32, then
the same epilogue in torch ops. A CUDA tensor reaches the kernel or
raises. ``QUANTIZE_LAUNCHES`` counts K6q's launches, ``LAUNCHES`` K6's
(once per call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stlpose_tpu_torch.kernels import _build, _ops
from stlpose_tpu_torch.kernels._build import I32, P

LAUNCHES = 0
QUANTIZE_LAUNCHES = 0
LAUNCHES_BY_KERNEL = {"wgmma": 0, "mma_sync": 0}
QUANTIZE_LAUNCHES_BY_KERNEL = {"tile": 0, "bytes": 0}
K_MULTIPLE = 32           # K of one wgmma m64nNk32 (and mma.sync m16n8k32)
ROUTES = ("wgmma", "mma_sync")
KERNELS = (1, 3)
STRIDES = (1, 2)
CONV_SYMBOLS = {torch.float32: "int8_conv_f32",
                torch.bfloat16: "int8_conv_bf16"}
QUANTIZE_SYMBOLS = {torch.float32: "quantize_activations_f32",
                    torch.bfloat16: "quantize_activations_bf16"}


def padded_k(kernel: int, cin: int) -> int:
    """K = kernel * kernel * cin, rounded up to a multiple of 32."""
    k = kernel * kernel * cin
    return -(-k // K_MULTIPLE) * K_MULTIPLE


def relayout_kernel_i8(w8):
    """int8 weights (C_out, C_in, kh, kw) -> K6's (C_out, Kpad): (C_out,
    kh, kw, C_in) flattened, zero weights after K."""
    O, C, kh, kw = w8.shape
    flat = w8.permute(0, 2, 3, 1).reshape(O, kh * kw * C)
    return F.pad(flat, (0, padded_k(kh, C) - flat.shape[1])).contiguous()


def kernel_i8_oihw(w8, kernel: int, cin: int):
    """K6's (C_out, Kpad) int8 weights back to (C_out, C_in, kh, kw)."""
    O = w8.shape[0]
    return w8[:, :kernel * kernel * cin].reshape(
        O, kernel, kernel, cin).permute(0, 3, 1, 2)


def quantize_activations_plain(x, sx, zp=None, qlo=None, qhi=None):
    """(N, C, H, W) f32 or bf16 -> (N, H, W, C) int8: ``clip(rint(x_f32 /
    sx), qlo, qhi) - zp``, or ``clip(rint(x_f32 / sx), -127, 127)`` without
    a zero point; ``sx``, ``zp``, ``qlo``, ``qhi`` are 0-d f32 tensors."""
    r = torch.round(x.float() / sx)
    q = torch.clamp(r, -127.0, 127.0) if zp is None else \
        torch.clamp(r, qlo, qhi) - zp
    return q.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def int8_conv_plain(xq, w8, kernel: int, stride: int, sx, sw, bias,
                    zp=None, relu: bool = True, out_dtype=torch.float32):
    """The int8 convolution of (N, H, W, C) codes with K6's (C_out, Kpad)
    weights, padded by ``kernel // 2`` with 0 (no zero point) or -zp, in
    float64 (exact), as int32; then ``acc_f32 * (sx * sw) + bias``,
    optional ReLU, ``out_dtype``, (N, C_out, Ho, Wo)."""
    N, H, W, C = xq.shape
    w = kernel_i8_oihw(w8, kernel, C).double()
    x = xq.permute(0, 3, 1, 2).double()
    pad = kernel // 2
    if pad:
        fill = torch.zeros((), dtype=torch.float64, device=xq.device) \
            if zp is None else -zp.double()
        xp = fill.expand(N, C, H + 2 * pad, W + 2 * pad).clone()
        xp[:, :, pad:pad + H, pad:pad + W] = x
        x = xp
    acc = F.conv2d(x, w, stride=stride).round().to(torch.int32)
    y = acc.float() * (sx * sw)[None, :, None, None] + \
        bias[None, :, None, None]
    if relu:
        y = F.relu(y)
    return y.to(out_dtype)


def _scalar_ptr(t, dev, name):
    if t is None:
        return None
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != dev:
        raise ValueError(f"{name}: a one-element f32 tensor on {dev} "
                         f"expected, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.data_ptr()


def _quantize_activations_cuda(x, sx, zp, qlo, qhi):
    """The CUDA implementation of operator
    ``stlpose::quantize_activations``."""
    global QUANTIZE_LAUNCHES
    dev = x.device
    if dev.type != "cuda" or x.dtype not in QUANTIZE_SYMBOLS or x.dim() != 4:
        raise ValueError(f"quantize_activations: a (N, C, H, W) float32 or "
                         f"bfloat16 CUDA tensor expected, got {x.dtype} "
                         f"{tuple(x.shape)} on {dev}")
    if (zp is None) != (qlo is None) or (zp is None) != (qhi is None):
        raise ValueError("quantize_activations: zp, qlo and qhi come "
                         "together")
    ptrs = [_scalar_ptr(t, dev, n) for t, n in
            ((sx, "sx"), (zp, "zp"), (qlo, "qlo"), (qhi, "qhi"))]
    if ptrs[0] is None:
        raise ValueError("quantize_activations: sx is required")
    x = x.contiguous()
    N, C, H, W = x.shape
    q = torch.empty((N, H, W, C), dtype=torch.int8, device=dev)
    if q.numel() == 0:
        return q
    launch = _build.launcher("int8_conv", QUANTIZE_SYMBOLS[x.dtype],
                             [P, P, I32, I32, I32, P, P, P, P, P])
    with torch.cuda.device(dev):
        launch(x.data_ptr(), q.data_ptr(), N, C, H * W, *ptrs,
               torch.cuda.current_stream().cuda_stream)
    QUANTIZE_LAUNCHES += 1
    QUANTIZE_LAUNCHES_BY_KERNEL["tile" if C % 16 == 0 else "bytes"] += 1
    return q


def _quantize_activations_fake(x, sx, zp, qlo, qhi):
    N, C, H, W = x.shape
    return x.new_empty((N, H, W, C), dtype=torch.int8)


QUANTIZE_OP = _ops.define(
    "quantize_activations(Tensor x, Tensor? sx, Tensor? zp, Tensor? qlo, "
    "Tensor? qhi) -> Tensor",
    quantize_activations_plain, _quantize_activations_cuda,
    _quantize_activations_fake)


def quantize_activations(x, sx, zp=None, qlo=None, qhi=None):
    """K6q: int8 NHWC codes of NCHW f32 or bf16 activations; see
    ``quantize_activations_plain``. Calls operator
    ``stlpose::quantize_activations``."""
    return QUANTIZE_OP(x, sx, zp, qlo, qhi)


def _int8_conv_cuda(xq, w8, kernel, stride, sx, sw, bias, zp, relu,
                    out_dtype, route):
    """The CUDA implementation of operator ``stlpose::int8_conv``."""
    global LAUNCHES
    dev = xq.device
    if (dev.type != "cuda" or xq.dtype != torch.int8 or xq.dim() != 4
            or not xq.is_contiguous()):
        raise ValueError(f"int8_conv: contiguous (N, H, W, C) int8 CUDA "
                         f"codes expected, got {xq.dtype} "
                         f"{tuple(xq.shape)} on {dev}")
    if kernel not in KERNELS or stride not in STRIDES:
        raise ValueError(f"int8_conv: kernel {kernel}, stride {stride}; "
                         f"supported: kernels {KERNELS}, strides {STRIDES}")
    if out_dtype not in CONV_SYMBOLS:
        raise ValueError(f"int8_conv: no kernel writes {out_dtype}")
    if route not in (None, *ROUTES):
        raise ValueError(f"int8_conv: route {route!r}; one of {ROUTES}")
    N, H, W, C = xq.shape
    O = w8.shape[0]
    if (w8.dtype != torch.int8 or w8.device != dev or not w8.is_contiguous()
            or tuple(w8.shape) != (O, padded_k(kernel, C))):
        raise ValueError(f"int8_conv: contiguous int8 weights (C_out, "
                         f"{padded_k(kernel, C)}) on {dev} expected, got "
                         f"{w8.dtype} {tuple(w8.shape)} on {w8.device}")
    for t, name in ((sw, "sw"), (bias, "bias")):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != (O,) or not t.is_contiguous()):
            raise ValueError(f"int8_conv: {name} must be ({O},) f32 on "
                             f"{dev}")
    if xq.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("int8_conv: codes and weights must start on 16 "
                         "bytes")
    sx_p, zp_p = _scalar_ptr(sx, dev, "sx"), _scalar_ptr(zp, dev, "zp")
    if sx_p is None:
        raise ValueError("int8_conv: sx is required")
    pad = kernel // 2
    Ho = (H + 2 * pad - kernel) // stride + 1
    Wo = (W + 2 * pad - kernel) // stride + 1
    if N * Ho * Wo >= 2 ** 31:
        raise ValueError("int8_conv: more than 2^31 output pixels")
    out = torch.empty((N, O, Ho, Wo), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if route is None:
        route = "wgmma" if C % 16 == 0 else "mma_sync"
    elif route == "wgmma" and C % 16:
        raise ValueError(f"int8_conv: the wgmma kernel takes C_in % 16 == "
                         f"0, got {C}")
    launch = _build.launcher("int8_conv", CONV_SYMBOLS[out_dtype],
                             [P] * 6 + [I32] * 8 + [P, P, I32])
    with torch.cuda.device(dev):
        launch(xq.data_ptr(), w8.data_ptr(), sx_p, sw.data_ptr(),
               bias.data_ptr(), zp_p, N, H, W, C, O, kernel, stride,
               int(relu), out.data_ptr(),
               torch.cuda.current_stream().cuda_stream, int(route == "wgmma"))
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[route] += 1
    return out


def _int8_conv_cpu(xq, w8, kernel, stride, sx, sw, bias, zp, relu,
                   out_dtype, route):
    return int8_conv_plain(xq, w8, kernel, stride, sx, sw, bias, zp, relu,
                           out_dtype)


def _int8_conv_fake(xq, w8, kernel, stride, sx, sw, bias, zp, relu,
                    out_dtype, route):
    N, H, W, _ = xq.shape
    pad = kernel // 2
    return xq.new_empty((N, w8.shape[0], (H + 2 * pad - kernel) // stride + 1,
                         (W + 2 * pad - kernel) // stride + 1),
                        dtype=out_dtype)


OP = _ops.define(
    "int8_conv(Tensor xq, Tensor w8, int kernel, int stride, Tensor? sx, "
    "Tensor sw, Tensor bias, Tensor? zp, bool relu, ScalarType out_dtype, "
    "str? route) -> Tensor",
    _int8_conv_cpu, _int8_conv_cuda, _int8_conv_fake)


def int8_conv(xq, w8, kernel: int, stride: int, sx, sw, bias, zp=None,
              relu: bool = True, out_dtype=torch.float32, *, route=None):
    """K6: the int8 convolution and its epilogue; see
    ``int8_conv_plain``. ``route`` None takes the ``wgmma`` kernel where
    C_in % 16 == 0 and the ``mma_sync`` one elsewhere; "mma_sync" forces
    the first design's kernel (timed beside the new one). Calls operator
    ``stlpose::int8_conv``."""
    return OP(xq, w8, kernel, stride, sx, sw, bias, zp, relu, out_dtype,
              route)
