"""K3: multilevel FPN RoIAlign (CUDA kernel ``csrc/roi_align.cu``).

Replaces ``stlpose_tpu/ops/pallas_roi.py::_roi_chunk_call`` (Pallas
kernels ``_roi_kernel_pp`` and ``_roi_kernel``) behind
``multilevel_roi_align_pallas_batched``, with and without ``patch_quant``.
Bound on the H100: the pooled output written plus the feature maps read
once; what the kernel serves is 16 taps per output from L1/L2. Design:
one block per box, the box's sample weights and tap offsets in shared
memory, the block walking the box's channel slices; a lane takes 16 bytes
of adjacent channels of one bin (8 for int8) and issues the bin's 16 tap
loads before it uses any. A C that is not a multiple of a lane's channels
takes a one-channel-at-a-time path inside the kernel.

The kernel is instantiated per (pyramid type, output type): float32 ->
float32, bfloat16 -> bfloat16, int8 -> float32 and int8 -> bfloat16. Taps
are widened to f32, all arithmetic runs in f32, an int8 pyramid's result
is multiplied by its level's (L, C) f32 scales, and the result is rounded
once to the output type.

``roi_align`` calls operator ``stlpose::roi_align`` (``kernels/_ops.py``),
which launches the instantiation that matches the tensors for CUDA
tensors and runs ``roi_align_plain`` for CPU tensors. ``LAUNCHES`` counts
kernel launches, ``LAUNCHES_BY_TYPE`` the launches of each instantiation.
The level of each box is an input: the caller computes it once
(``ops/roi_align.py::_assign_levels``) and hands the same vector to either
version, since a level flip is a large error, not a rounding one.

K3b (``csrc/roi_align_backward.cu``) is the gradient of the f32
instantiation with respect to the maps, for detector training. It has no
Pallas original: the JAX package differentiates XLA's
``stlpose_tpu/ops/roi_align.py::multilevel_roi_align`` by autodiff.
``roi_align_backward`` launches it for CUDA tensors (f32 only) and runs
``roi_align_backward_plain``, the autograd of ``roi_align_plain``, for CPU
tensors; ``BACKWARD_LAUNCHES`` counts its wrapper calls. It is a
deterministic gather with no atomics, two launches a call: a pre-pass
gives each box the pixel range of its taps on its level (its taps fall
on at most 28 columns and 28 rows), then a block per (image, level, 8
pixels of a row) keeps the boxes whose range reaches them, and a warp
per pixel sums the pixel's contributions in registers (8 channels a
lane) in a fixed order (box index, bin, sample, tap) and writes each
element once: the same bits on every run, and no zero fill. ``RoIAlignFunction`` ties the two into autograd:
forward K3 ``f32_f32``, backward K3b; boxes and levels get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from stlpose_tpu_torch.kernels import _build, _ops
from stlpose_tpu_torch.kernels._build import F32, I32, P

LAUNCHES = 0
BACKWARD_LAUNCHES = 0
OUTPUT_SIZE = 7
SAMPLING_RATIO = 2
MAX_LEVELS = 4

# (pyramid dtype, output dtype) -> instantiation
VARIANTS = {(torch.float32, torch.float32): "f32_f32",
            (torch.bfloat16, torch.bfloat16): "bf16_bf16",
            (torch.int8, torch.float32): "i8_f32",
            (torch.int8, torch.bfloat16): "i8_bf16"}
LAUNCHES_BY_TYPE = dict.fromkeys(VARIANTS.values(), 0)


def _variant(level_dtype, out_dtype, scales):
    """The instantiation for these types; raises for any other combination
    (nothing is converted to f32 behind the caller's back). An int8
    pyramid needs its scales, a float one takes none."""
    name = VARIANTS.get((level_dtype, out_dtype))
    if name is None or (scales is None) != (level_dtype != torch.int8):
        raise ValueError(
            f"roi_align: no kernel for {level_dtype} levels -> {out_dtype} "
            f"{'with' if scales is not None else 'without'} scales; "
            f"supported: {sorted(VARIANTS.values())} (scales with int8 only)")
    return name


def roi_align_single_level(features, boxes, img, spatial_scale: float):
    """RoIAlign of (N, 4) xyxy image-space boxes, box n against image
    ``img[n]`` of the (B, H, W, C) map; torchvision aligned=False border
    rules, 7x7 bins of 2x2 samples. Taps are widened to f32. Returns
    (N, 7, 7, C) f32."""
    B, H, W, C = features.shape
    n, sr = OUTPUT_SIZE, SAMPLING_RATIO
    dev = features.device
    s = torch.arange(n * sr, device=dev)
    pos = (s // sr).to(torch.float32) + ((s % sr).to(torch.float32) + 0.5) / sr
    b = boxes * spatial_scale
    # a device tensor, not a Python number: CUDA divides by a host scalar
    # as a multiply by its reciprocal, one rounding off the kernel's
    n_t = torch.tensor(float(n), device=dev)

    def axis(lo, hi, size):
        roi = torch.clamp(hi - lo, min=1.0)
        g = lo[:, None] + pos[None, :] * (roi / n_t)[:, None]   # (N, ns)
        inside = (g >= -1.0) & (g <= size)
        gc = torch.clamp(g, 0.0, size - 1)
        g0 = torch.floor(gc)
        i0 = g0.to(torch.int64)
        return i0, (i0 + 1).clamp(max=size - 1), gc - g0, inside

    x0, x1, fx, inx = axis(b[:, 0], b[:, 2], W)
    y0, y1, fy, iny = axis(b[:, 1], b[:, 3], H)
    flat = features.reshape(B * H * W, C)
    base = img.to(torch.int64)[:, None, None] * (H * W)

    def tap(yi, xi):                                 # (N, ns_y, ns_x, C)
        return flat[base + yi[:, :, None] * W + xi[:, None, :]] \
            .to(torch.float32)

    fx, fy = fx[:, None, :, None], fy[:, :, None, None]
    v = (tap(y0, x0) * ((1.0 - fx) * (1.0 - fy)) +
         tap(y0, x1) * (fx * (1.0 - fy)) +
         tap(y1, x0) * ((1.0 - fx) * fy) +
         tap(y1, x1) * (fx * fy))
    inside = (iny[:, :, None] & inx[:, None, :])[..., None]
    v = torch.where(inside, v, 0.0).reshape(-1, n, sr, n, sr, C)
    return (v[:, :, 0, :, 0] + v[:, :, 0, :, 1] + v[:, :, 1, :, 0] +
            v[:, :, 1, :, 1]) * 0.25


def roi_align_plain(feature_levels, boxes, levels, strides, scales=None,
                    out_dtype=torch.float32):
    """Plain PyTorch version of the kernel.

    feature_levels: L <= 4 maps (B, h_l, w_l, C), all float32, all
    bfloat16 or all int8; boxes (B, P, 4) f32 xyxy image pixels; levels
    (B, P) int32 in [0, L) (a box with another level pools zeros);
    strides: per level; scales: (L, C) f32 for an int8 pyramid (each
    box's pooled f32 result is multiplied by its level's row), else None;
    out_dtype: float32 or bfloat16, one rounding at the end. Returns
    (B, P, 7, 7, C) of ``out_dtype``."""
    _variant(feature_levels[0].dtype, out_dtype, scales)
    B, P = boxes.shape[:2]
    C = feature_levels[0].shape[-1]
    flat = boxes.reshape(B * P, 4)
    lv = levels.reshape(B * P)
    img = torch.arange(B, device=boxes.device).repeat_interleave(P)
    out = torch.zeros((B * P, OUTPUT_SIZE, OUTPUT_SIZE, C),
                      dtype=torch.float32, device=boxes.device)
    for li, (feat, stride) in enumerate(zip(feature_levels, strides)):
        sel = torch.nonzero(lv == li)[:, 0]
        if sel.numel():
            pooled = roi_align_single_level(feat, flat[sel], img[sel],
                                            1.0 / stride)
            if scales is not None:
                pooled = pooled * scales[li]
            out[sel] = pooled
    return out.to(out_dtype).reshape(B, P, OUTPUT_SIZE, OUTPUT_SIZE, C)


def _roi_align_cuda(feature_levels, boxes, levels, strides, scales,
                    out_dtype):
    """The CUDA implementation of operator ``stlpose::roi_align``."""
    global LAUNCHES
    B, NB = boxes.shape[:2]
    L = len(feature_levels)
    C = feature_levels[0].shape[-1]
    dev = boxes.device
    dtype = feature_levels[0].dtype
    if (dev.type != "cuda" or boxes.dtype != torch.float32
            or boxes.shape != (B, NB, 4) or levels.shape != (B, NB)
            or levels.device != dev):
        raise ValueError("roi_align: expected float32 CUDA boxes (B, P, 4) "
                         "and levels (B, P) on the same device")
    if not 1 <= L <= MAX_LEVELS or len(strides) < L:
        raise ValueError(f"roi_align: 1..{MAX_LEVELS} levels with strides "
                         f"expected, got {L} levels, {len(strides)} strides")
    for f in feature_levels:
        if (f.device != dev or f.dtype != dtype or f.dim() != 4
                or f.shape[0] != B or f.shape[-1] != C):
            raise ValueError(f"roi_align: every level must be a {dtype} "
                             f"(B={B}, h, w, C={C}) map on {dev}")
    variant = _variant(dtype, out_dtype, scales)
    if scales is not None:
        if (scales.device != dev or scales.dtype != torch.float32
                or tuple(scales.shape) != (L, C)):
            raise ValueError(f"roi_align: scales must be float32 ({L}, {C}) "
                             f"on {dev}")
        scales = scales.contiguous()
    feats = [f.contiguous() for f in feature_levels]
    boxes = boxes.contiguous()
    lv32 = levels.to(torch.int32).contiguous()
    out = torch.empty((B, NB, OUTPUT_SIZE, OUTPUT_SIZE, C), dtype=out_dtype,
                      device=dev)
    ptrs = [f.data_ptr() for f in feats] + [None] * (MAX_LEVELS - L)
    hw = []
    for i in range(MAX_LEVELS):
        hw += ([feats[i].shape[1], feats[i].shape[2]] if i < L else [0, 0])
    inv = [1.0 / s for s in strides[:L]] + [0.0] * (MAX_LEVELS - L)
    launch = _build.launcher(
        "roi_align", f"roi_align_{variant}",
        [P] * MAX_LEVELS + [I32] * (2 * MAX_LEVELS) + [F32] * MAX_LEVELS +
        [I32] * 2 + [P] * 2 + [I32] * 2 + [P] * 3)
    with torch.cuda.device(dev):
        launch(*ptrs, *hw, *inv, L, C, boxes.data_ptr(), lv32.data_ptr(),
               B, NB, None if scales is None else scales.data_ptr(),
               out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    LAUNCHES_BY_TYPE[variant] += 1
    return out


def _roi_align_fake(feature_levels, boxes, levels, strides, scales,
                    out_dtype):
    _variant(feature_levels[0].dtype, out_dtype, scales)
    B, NB = boxes.shape[:2]
    return boxes.new_empty((B, NB, OUTPUT_SIZE, OUTPUT_SIZE,
                            feature_levels[0].shape[-1]), dtype=out_dtype)


OP = _ops.define("roi_align(Tensor[] feature_levels, Tensor boxes, "
                 "Tensor levels, float[] strides, Tensor? scales, "
                 "ScalarType out_dtype) -> Tensor",
                 roi_align_plain, _roi_align_cuda, _roi_align_fake)


def roi_align(feature_levels, boxes, levels, strides, scales=None,
              out_dtype=torch.float32):
    """Multilevel RoIAlign; see ``roi_align_plain`` for the contract.
    Calls operator ``stlpose::roi_align``."""
    return OP(list(feature_levels), boxes, levels,
              [float(s) for s in strides], scales, out_dtype)


def roi_align_backward_plain(grad, level_shapes, boxes, levels, strides):
    """Plain PyTorch version of K3b: the gradient of
    ``roi_align_plain(maps, boxes, levels, strides)`` (f32 maps, f32 out)
    with respect to the maps, by autograd. grad (B, P, 7, 7, C) f32;
    level_shapes: the (B, h_l, w_l, C) of each level. Returns one f32 map
    per level. The function is linear in the maps, so its gradient does
    not depend on their values."""
    if grad.dtype != torch.float32:
        raise ValueError(f"roi_align_backward: float32 gradients only, got "
                         f"{grad.dtype}")
    with torch.enable_grad():
        maps = [torch.zeros(tuple(s), dtype=torch.float32,
                            device=grad.device, requires_grad=True)
                for s in level_shapes]
        out = roi_align_plain(maps, boxes, levels, strides)
        grads = torch.autograd.grad(out, maps, grad, allow_unused=True)
    # a level that no box reads has no gradient: zeros
    return [torch.zeros_like(m) if g is None else g
            for m, g in zip(maps, grads)]


def roi_align_backward(grad, level_shapes, boxes, levels, strides):
    """K3b: the gradient of K3's f32 pooling with respect to the maps; see
    ``roi_align_backward_plain`` for the contract. On the card: float32
    CUDA grad (B, P, 7, 7, C), boxes (B, P, 4) and levels (B, P) on the
    same device, 1-4 levels; two kernel launches, every map element
    written by the second."""
    if boxes.device.type == "cpu":
        return roi_align_backward_plain(grad, level_shapes, boxes, levels,
                                        strides)
    global BACKWARD_LAUNCHES
    B, NB = boxes.shape[:2]
    L = len(level_shapes)
    C = level_shapes[0][-1] if L else 0
    dev = boxes.device
    if (dev.type != "cuda" or boxes.dtype != torch.float32
            or boxes.shape != (B, NB, 4) or levels.shape != (B, NB)
            or levels.device != dev or grad.device != dev
            or grad.shape != (B, NB, OUTPUT_SIZE, OUTPUT_SIZE, C)):
        raise ValueError("roi_align_backward: expected float32 CUDA boxes "
                         "(B, P, 4), levels (B, P) and grad (B, P, 7, 7, C) "
                         "on one device")
    if grad.dtype != torch.float32:
        raise ValueError(f"roi_align_backward: float32 gradients only, got "
                         f"{grad.dtype}")
    if not 1 <= L <= MAX_LEVELS or len(strides) < L or any(
            len(s) != 4 or s[0] != B or s[-1] != C for s in level_shapes):
        raise ValueError(f"roi_align_backward: 1..{MAX_LEVELS} levels of "
                         f"(B={B}, h, w, C={C}) with strides expected")
    grad = grad.contiguous()
    boxes = boxes.contiguous()
    lv32 = levels.to(torch.int32).contiguous()
    maps = [torch.empty(tuple(s), dtype=torch.float32, device=dev)
            for s in level_shapes]
    scratch_bytes = _build.function(
        "roi_align_backward", "roi_align_backward_scratch_bytes", [I32],
        ctypes.c_longlong)
    scratch = torch.empty(scratch_bytes(B * NB), dtype=torch.uint8,
                          device=dev)
    ptrs = [m.data_ptr() for m in maps] + [None] * (MAX_LEVELS - L)
    hw = []
    for i in range(MAX_LEVELS):
        hw += ([level_shapes[i][1], level_shapes[i][2]] if i < L else [0, 0])
    inv = [1.0 / s for s in strides[:L]] + [0.0] * (MAX_LEVELS - L)
    launch = _build.launcher(
        "roi_align_backward", "roi_align_backward_f32",
        [P] * MAX_LEVELS + [I32] * (2 * MAX_LEVELS) + [F32] * MAX_LEVELS +
        [I32] * 2 + [P] * 2 + [I32] * 2 + [P] * 3)
    with torch.cuda.device(dev):
        launch(*ptrs, *hw, *inv, L, C, boxes.data_ptr(), lv32.data_ptr(),
               B, NB, grad.data_ptr(), scratch.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    BACKWARD_LAUNCHES += 1
    return maps


class RoIAlignFunction(torch.autograd.Function):
    """Multilevel RoIAlign of f32 maps with a gradient for the maps:
    forward K3 ``f32_f32`` (``roi_align``), backward K3b
    (``roi_align_backward``); each takes its plain version for CPU
    tensors. ``apply(boxes, levels, strides, *maps)``; boxes and levels
    get no gradient (the detector's proposals and ground truth are
    constants of the loss)."""

    @staticmethod
    def forward(ctx, boxes, levels, strides, *feature_levels):
        if any(f.dtype != torch.float32 for f in feature_levels):
            raise ValueError("RoIAlignFunction: float32 maps only, got "
                             f"{sorted({str(f.dtype) for f in feature_levels})}")
        ctx.save_for_backward(boxes, levels)
        ctx.strides = tuple(strides)
        ctx.level_shapes = [tuple(f.shape) for f in feature_levels]
        return roi_align(list(feature_levels), boxes, levels, strides)

    @staticmethod
    def backward(ctx, grad):
        boxes, levels = ctx.saved_tensors
        maps = roi_align_backward(grad, ctx.level_shapes, boxes, levels,
                                  ctx.strides)
        return (None, None, None, *maps)
