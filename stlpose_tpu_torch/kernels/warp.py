"""K2: batched affine crop warp (CUDA kernel ``csrc/warp.cu``).

Replaces ``stlpose_tpu/ops/pallas_warp.py::_pallas_warp_call`` (Pallas
kernel ``_warp_kernel``) behind ``crop_from_center_scale_batched_pallas``
and ``crop_from_center_scale_pallas``. Bound on the H100: the crops
written (most of the bytes) plus the source images read. Design: a block
per (crop, band of 8 rows) with the crop's params read once; a warp per
32 consecutive pixels of a row, so that its tap loads stay close in the
source; where dst_w*C is a multiple of 4, the band staged in shared
memory and written by one bulk copy; for unrotated crops (b == 0,
decided per crop on the device) the column taps computed once per block
and the row taps once per row; rotated crops sample directly.

``affine_crop`` launches the kernel for CUDA tensors and runs
``affine_crop_plain`` for CPU tensors. Inside the launch, the kernel's
C = 3 instantiation takes three-channel images (any other C runs a loop
over channels), and the band goes out by one bulk copy where dst_w*C is
a multiple of 4 and a band fits in 24 KB (value by value otherwise). ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import _build
from stlpose_tpu_torch.kernels._build import I32, P

LAUNCHES = 0


def affine_crop_plain(images, params, img_idx, output_size):
    """Plain PyTorch version of the kernel.

    images (B, H, W, C) f32; params (K, 4) f32 rows (a, b, tx, ty) of the
    inverse (destination -> source) map; img_idx (K,) int; output_size
    (dst_w, dst_h). Returns (K, dst_h, dst_w, C): bilinear samples, each
    tap outside the image reading 0; a crop whose img_idx is outside
    [0, B) reads zeros only (checked per crop, with no host sync)."""
    B, H, W, C = images.shape
    dst_w, dst_h = output_size
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(dst_h, dtype=torch.float32, device=dev),
                            torch.arange(dst_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    a, b, tx, ty = (params[:, i, None, None] for i in range(4))
    sx = a * gx - b * gy + tx
    sy = b * gx + a * gy + ty
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = images.reshape(B * H * W, C)
    img = img_idx.to(torch.int64)[:, None, None]
    img_ok = (img >= 0) & (img < B)
    base = img.clamp(0, B - 1) * (H * W)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & img_ok
        lin = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return torch.where(valid[..., None], flat[lin], 0.0)

    w00 = ((1.0 - fx) * (1.0 - fy))[..., None]
    w01 = (fx * (1.0 - fy))[..., None]
    w10 = ((1.0 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return (tap(y0i, x0i) * w00 + tap(y0i, x0i + 1) * w01 +
            tap(y0i + 1, x0i) * w10 + tap(y0i + 1, x0i + 1) * w11)


def affine_crop(images, params, img_idx, output_size):
    """K crops of (B, H, W, C) images; see ``affine_crop_plain``."""
    if images.device.type == "cpu":
        return affine_crop_plain(images, params, img_idx, output_size)
    global LAUNCHES
    B, H, W, C = images.shape
    K = params.shape[0]
    dst_w, dst_h = output_size
    dev = images.device
    if (dev.type != "cuda" or images.dtype != torch.float32
            or params.dtype != torch.float32 or params.shape != (K, 4)
            or img_idx.shape != (K,) or params.device != dev
            or img_idx.device != dev):
        raise ValueError("affine_crop: expected float32 CUDA images "
                         "(B, H, W, C), float32 params (K, 4) and img_idx "
                         "(K,) on the same device")
    images = images.contiguous()
    params = params.contiguous()
    idx32 = img_idx.to(torch.int32).contiguous()
    out = torch.empty((K, dst_h, dst_w, C), dtype=torch.float32, device=dev)
    launch = _build.launcher("warp", "affine_crop_launch",
                             [P] + [I32] * 4 + [P] * 2 + [I32] * 3 + [P] * 2)
    with torch.cuda.device(dev):
        launch(images.data_ptr(), B, H, W, C, params.data_ptr(),
               idx32.data_ptr(), K, dst_h, dst_w, out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out
