"""K1: heatmap peak decode (CUDA kernels in ``csrc/decode.cu``).

Replaces ``stlpose_tpu/ops/pallas_decode.py::heatmap_peaks_pallas``
(Pallas kernel ``_decode_kernel``). Bound on the H100: the heatmap read,
N*J*H*W*4 bytes. Keeping enough of those bytes in flight is the design:
for contiguous maps the bulk kernel (one block per map) copies the whole
map into shared memory with one bulk asynchronous copy on an mbarrier,
then reduces it with float4 reads and a (value, lowest index) merge; any
other strides go to the strided kernel (a warp per map, rows then
columns).

``heatmap_peaks`` calls operator ``stlpose::heatmap_peaks``
(``kernels/_ops.py``), which runs ``heatmap_peaks_plain`` (the same
function in plain PyTorch) for a CPU tensor. For a CUDA tensor it
launches the bulk kernel when the maps are contiguous (unit column
stride, row stride W), their bytes a multiple of 16 and at most 48 KB,
and every map starts on 16 bytes; otherwise the strided kernel.
``LAUNCHES`` counts launches of either, ``LAUNCHES_BY_KERNEL`` each one.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import _build, _ops
from stlpose_tpu_torch.kernels._build import I32, I64, P

LAUNCHES = 0
LAUNCHES_BY_KERNEL = {"bulk": 0, "strided": 0}
MAX_MAP_BYTES = 48 * 1024     # one shared-memory buffer of the bulk kernel


def heatmap_peaks_plain(heatmaps):
    """Plain PyTorch version of the kernel. heatmaps: (N, J, H, W) f32.

    Returns coords (N, J, 2) unrefined (x, y), zeroed where max <= 0;
    maxvals (N, J); shift (N, J, 2), the +-0.25 px sub-pixel shift (0
    where the peak is not strictly inside the border)."""
    N, J, H, W = heatmaps.shape
    flat = heatmaps.reshape(N, J, H * W)
    maxvals, idx = torch.max(flat, dim=-1)
    # torch.max does not promise the first index on ties: take the
    # lowest index holding the max, as jnp.argmax does
    pos = torch.arange(H * W, device=flat.device).expand_as(flat)
    idx = torch.where(flat == maxvals[..., None], pos, H * W).amin(dim=-1)
    valid = (maxvals > 0.0).to(torch.float32)
    # integer division: equal to floor(f32(idx) / W) for these sizes, and
    # immune to CUDA's divide-by-reciprocal for a scalar divisor
    x = (idx % W).to(torch.float32) * valid
    y = (idx // W).to(torch.float32) * valid
    coords = torch.stack([x, y], dim=-1)

    px = torch.floor(x + 0.5).to(torch.int64)
    py = torch.floor(y + 0.5).to(torch.int64)
    ok = ((px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)).to(torch.float32)
    pxc = px.clamp(1, W - 2)
    pyc = py.clamp(1, H - 2)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * W + xx)[..., None])[..., 0]

    dx = at(pyc, pxc + 1) - at(pyc, pxc - 1)
    dy = at(pyc + 1, pxc) - at(pyc - 1, pxc)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords, maxvals, shift * ok[..., None]


def takes_bulk_kernel(heatmaps) -> bool:
    """Whether a CUDA ``heatmaps`` tensor goes to the bulk kernel: unit
    column stride, row stride W, 16-byte map bases and map sizes (a
    multiple of 16 bytes, at most ``MAX_MAP_BYTES``)."""
    _, _, H, W = heatmaps.shape
    sN, sJ, sH, sW = heatmaps.stride()
    return (sW == 1 and sH == W and (H * W) % 4 == 0
            and H * W * 4 <= MAX_MAP_BYTES and sN % 4 == 0 and sJ % 4 == 0
            and heatmaps.data_ptr() % 16 == 0)


def _heatmap_peaks_cuda(heatmaps):
    """The CUDA implementation of operator ``stlpose::heatmap_peaks``."""
    global LAUNCHES
    if heatmaps.device.type != "cuda" or heatmaps.dtype != torch.float32 \
            or heatmaps.dim() != 4:
        raise ValueError("heatmap_peaks: expected a 4-D float32 CUDA "
                         f"tensor, got {heatmaps.dtype} {heatmaps.device} "
                         f"{tuple(heatmaps.shape)}")
    N, J, H, W = heatmaps.shape
    if H < 3 or W < 3:
        raise ValueError(f"heatmap_peaks: maps of {H}x{W} are too small")
    coords = torch.empty((N, J, 2), dtype=torch.float32,
                         device=heatmaps.device)
    maxvals = torch.empty((N, J), dtype=torch.float32,
                          device=heatmaps.device)
    shift = torch.empty((N, J, 2), dtype=torch.float32,
                        device=heatmaps.device)
    outs = (coords.data_ptr(), maxvals.data_ptr(), shift.data_ptr())
    sN, sJ, sH, sW = heatmaps.stride()
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        if takes_bulk_kernel(heatmaps):
            kernel = "bulk"
            _build.launcher("decode", "heatmap_peaks_bulk_launch",
                            [P] + [I64] * 2 + [I32] * 4 + [P] * 4)(
                heatmaps.data_ptr(), sN, sJ, N, J, H, W, *outs, stream)
        else:
            kernel = "strided"
            _build.launcher("decode", "heatmap_peaks_strided_launch",
                            [P] + [I64] * 4 + [I32] * 4 + [P] * 4)(
                heatmaps.data_ptr(), sN, sJ, sH, sW, N, J, H, W, *outs,
                stream)
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[kernel] += 1
    return coords, maxvals, shift


def _heatmap_peaks_fake(heatmaps):
    N, J = heatmaps.shape[:2]
    return (heatmaps.new_empty((N, J, 2), dtype=torch.float32),
            heatmaps.new_empty((N, J), dtype=torch.float32),
            heatmaps.new_empty((N, J, 2), dtype=torch.float32))


OP = _ops.define("heatmap_peaks(Tensor heatmaps) -> (Tensor, Tensor, Tensor)",
                 heatmap_peaks_plain, _heatmap_peaks_cuda,
                 _heatmap_peaks_fake)


def heatmap_peaks(heatmaps):
    """Peaks of (N, J, H, W) f32 heatmaps; any strides (the NHWC model
    output viewed as NJHW is read in place). See ``heatmap_peaks_plain``
    for the outputs. Calls operator ``stlpose::heatmap_peaks``."""
    return OP(heatmaps)
