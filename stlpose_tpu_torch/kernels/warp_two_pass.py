"""K4: two-pass rotated crop warp (CUDA kernel ``csrc/warp_two_pass.cu``).

Replaces ``stlpose_tpu/ops/pallas_warp.py::affine_warp_pallas`` (Pallas
kernel ``_warp_kernel``): the Catmull-Smith two-pass filter that makes the
rotated training crops of the device-warp pipeline. For a rotated crop it
is a different function from K2's direct bilinear sample (pass 1 samples
each source row at its own sheared x). Bound on the H100: the crops
written plus the canvas pixels under them read. Design: a block per
(crop, 32 x 32 output tile), lines of 32 pixels along the output row, or
along the output column in a crop with the 90-degree conditioning turn
(folded into the indexing), so that neighbouring lanes read neighbouring
canvas bytes; all taps of a pixel loaded before the first use; a turned
crop's tile staged in shared memory and written by rows with bulk
copies; uint8 or f32 canvases read directly.

``warp_two_pass`` launches the kernel for CUDA tensors and runs
``warp_two_pass_plain`` for CPU tensors. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import _build
from stlpose_tpu_torch.kernels._build import I32, P

LAUNCHES = 0


def _lerp_along(src, pos, dim):
    """1-D linear resample of (N, A, B, C) ``src`` along ``dim`` (1 or 2)
    at (N, ., .) positions ``pos``: ``g0*(1-f) + g1*f`` with each tap
    outside the axis reading 0, as ``_chunked_lane_resample`` rounds."""
    size = src.shape[dim]
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = p0.clamp(-2, size + 1).to(torch.int64)

    def tap(i):
        valid = (i >= 0) & (i < size)
        idx = i.clamp(0, size - 1)[..., None].expand(*i.shape, src.shape[3])
        return torch.where(valid[..., None], torch.gather(src, dim, idx), 0.0)

    w = frac[..., None]
    return tap(i0) * (1.0 - w) + tap(i0 + 1) * w


def warp_two_pass_plain(images, params, output_size):
    """Plain PyTorch version of the kernel, step by step as the Pallas
    kernel runs: the turned canvases materialised, then pass 1 for every
    source row, then pass 2.

    images (N, S, S, C) uint8 or f32; params (N, 8) f32 rows
    (u, r, txr, b, a, ty, swap, 0) of the conditioned inverse map
    (``ops.warp.two_pass_params``); output_size (dst_w, dst_h). Returns
    (N, dst_h, dst_w, C) f32, zero where the taps leave the canvas."""
    N, S, _, C = images.shape
    dst_w, dst_h = output_size
    dev = images.device
    imgs = images.to(torch.float32)
    swap = params[:, 6] != 0
    imgs = torch.where(swap[:, None, None, None],
                       torch.rot90(imgs, 1, (1, 2)), imgs)
    u, r, txr, b, a, ty = (params[:, i, None, None] for i in range(6))
    # pass 1: source row y resampled along x at X(x', y) -> h (N, S, DW, C)
    row = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
    col = torch.arange(dst_w, dtype=torch.float32, device=dev)[None, :]
    h = _lerp_along(imgs, u * col - r * row + txr, dim=2)
    # pass 2: column x' of h resampled along y at Y(x', y')
    yy = torch.arange(dst_h, dtype=torch.float32, device=dev)[:, None]
    return _lerp_along(h, b * col + a * yy + ty, dim=1)


def warp_two_pass(images, params, output_size):
    """Crop n of canvas n through the two-pass filter; see
    ``warp_two_pass_plain``."""
    if images.device.type == "cpu":
        return warp_two_pass_plain(images, params, output_size)
    global LAUNCHES
    N, S, S2, C = images.shape
    dst_w, dst_h = output_size
    dev = images.device
    if (dev.type != "cuda" or images.dtype not in (torch.uint8, torch.float32)
            or S != S2 or params.dtype != torch.float32
            or params.shape != (N, 8) or params.device != dev):
        raise ValueError("warp_two_pass: expected uint8 or float32 CUDA "
                         "canvases (N, S, S, C) and float32 params (N, 8) "
                         "on the same device")
    if S * S * C >= 2 ** 31:
        raise ValueError(f"warp_two_pass: a {S}x{S}x{C} canvas is over the "
                         f"kernel's 32-bit offsets")
    images = images.contiguous()
    params = params.contiguous()
    out = torch.empty((N, dst_h, dst_w, C), dtype=torch.float32, device=dev)
    symbol = ("warp_two_pass_u8_launch" if images.dtype == torch.uint8
              else "warp_two_pass_f32_launch")
    launch = _build.launcher("warp_two_pass", symbol,
                             [P] + [I32] * 3 + [P] + [I32] * 2 + [P] * 2)
    with torch.cuda.device(dev):
        launch(images.data_ptr(), N, S, C, params.data_ptr(), dst_h, dst_w,
               out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out
