"""K3q: int8 quantization of an FPN pyramid (CUDA kernels in
``csrc/quantize.cu``).

Replaces the quantize prologue of ``stlpose_tpu/ops/pallas_roi.py::
multilevel_roi_align_pallas_batched(patch_quant=True)`` (pallas_roi.py:
417-429), which feeds K3's int8 instantiations. Bound on the H100: the
pyramid read once, plus what of it the 50 MB L2 cannot keep until the
second pass (the absmax over the whole batch completes before the first
element is quantized), and the int8 pyramid written. Design: two
kernels, all levels in one launch of each: an absmax pass (16-byte loads,
a reduction per block, ``atomicMax`` on the f32 bits into a zeroed (L, C)
buffer), then a quantize pass (each thread 16 elements to one 16-byte int8
store, true f32 divisions), which walks the pyramid in reverse to start on
what the first pass left in L2.

``quantize_levels`` calls operator ``stlpose::quantize_levels``
(``kernels/_ops.py``), which launches the pair for CUDA tensors and runs
``quantize_levels_plain`` for CPU tensors. The kernels read and write 16
bytes at a time: a CUDA pyramid whose C is not a multiple of 16, or whose
maps do not start on 16 bytes, raises. ``LAUNCHES`` counts the launches
of the pair.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import _build, _ops
from stlpose_tpu_torch.kernels._build import I32, I64, P

LAUNCHES = 0
MAX_LEVELS = 4
MAX_CHANNELS = 1024       # one thread per channel in a block of the absmax
CHANNEL_MULTIPLE = 16     # channels of one 16-byte int8 store
SYMBOLS = {torch.float32: "quantize_levels_f32",
           torch.bfloat16: "quantize_levels_bf16"}


def _check_dtype(feature_levels):
    dtype = feature_levels[0].dtype
    if dtype not in SYMBOLS or any(f.dtype != dtype for f in feature_levels):
        raise ValueError(
            f"quantize_levels: no kernel for {[f.dtype for f in feature_levels]}"
            f" levels; supported: float32 or bfloat16, all levels alike")


def quantize_levels_plain(feature_levels):
    """Symmetric int8 quantization of each (B, h, w, C) level with one
    scale per (level, channel), taken over the whole batch (the absmax
    runs over B, h and w, so one image's pooled features depend on the
    other images of the batch, as in the JAX package). In f32:
    ``s = max(absmax, 1e-8) / 127``, ``q = clip(round(x / s), -127, 127)``
    with round half to even. Levels are float32 or bfloat16. Returns
    (int8 levels, (L, C) f32 scales).

    Own copy of ``stlpose_tpu/ops/pallas_roi.py:418-429``. The JAX
    wrapper skips quantization when C % 128 != 0 outside interpret mode
    (Mosaic's lane-tile limit); this function quantizes at every C."""
    _check_dtype(feature_levels)
    q, scales = [], []
    for f in feature_levels:
        x = f.to(torch.float32)
        # device tensors, not Python numbers: CUDA divides by a host
        # scalar as a multiply by its reciprocal, one rounding off
        s = torch.clamp(x.abs().amax(dim=(0, 1, 2)), min=1e-8) / \
            torch.tensor(127.0, device=x.device)
        q.append(torch.clamp(torch.round(x / s), -127, 127).to(torch.int8))
        scales.append(s)
    return q, torch.stack(scales)


def _quantize_levels_cuda(feature_levels):
    """The CUDA implementation of operator ``stlpose::quantize_levels``."""
    global LAUNCHES
    _check_dtype(feature_levels)
    L = len(feature_levels)
    f0 = feature_levels[0]
    dev, C = f0.device, f0.shape[-1]
    if (not 1 <= L <= MAX_LEVELS or not 1 <= C <= MAX_CHANNELS
            or C % CHANNEL_MULTIPLE):
        raise ValueError(f"quantize_levels: 1..{MAX_LEVELS} levels of a "
                         f"multiple of {CHANNEL_MULTIPLE} channels up to "
                         f"{MAX_CHANNELS} expected, got {L} of {C}")
    for f in feature_levels:
        if (f.device != dev or f.dim() != 4 or f.shape[-1] != C
                or f.numel() == 0):
            raise ValueError(f"quantize_levels: every level must be a "
                             f"non-empty (B, h, w, C={C}) map on {dev}")
    xs = [f.contiguous() for f in feature_levels]
    if any(f.data_ptr() % 16 for f in xs):
        raise ValueError("quantize_levels: every map must start on 16 bytes")
    qs = [torch.empty(f.shape, dtype=torch.int8, device=dev) for f in xs]
    absmax = torch.zeros((L, C), dtype=torch.float32, device=dev)
    scales = torch.empty((L, C), dtype=torch.float32, device=dev)
    pad = [None] * (MAX_LEVELS - L)
    pixels = [f.numel() // C for f in xs] + [0] * (MAX_LEVELS - L)
    launch = _build.launcher(
        "quantize", SYMBOLS[f0.dtype],
        [P] * MAX_LEVELS + [I64] * MAX_LEVELS + [I32] * 2 +
        [P] * MAX_LEVELS + [P] * 3)
    with torch.cuda.device(dev):
        launch(*[f.data_ptr() for f in xs], *pad, *pixels, L, C,
               *[q.data_ptr() for q in qs], *pad, absmax.data_ptr(),
               scales.data_ptr(), torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return qs, scales


def _quantize_levels_fake(feature_levels):
    _check_dtype(feature_levels)
    f0 = feature_levels[0]
    return ([f.new_empty(f.shape, dtype=torch.int8) for f in feature_levels],
            f0.new_empty((len(feature_levels), f0.shape[-1]),
                         dtype=torch.float32))


OP = _ops.define("quantize_levels(Tensor[] feature_levels) -> "
                 "(Tensor[], Tensor)",
                 quantize_levels_plain, _quantize_levels_cuda,
                 _quantize_levels_fake)


def quantize_levels(feature_levels):
    """int8 levels and (L, C) f32 scales of 1..4 float32 or bfloat16
    levels (B, h, w, C) of one C; see ``quantize_levels_plain``. Calls
    operator ``stlpose::quantize_levels``."""
    _check_dtype(feature_levels)
    q, scales = OP(list(feature_levels))
    return list(q), scales
