"""K5: greedy NMS as a score-sorted IoU bitmask plus one scan (CUDA
kernels ``csrc/nms.cu``).

Has no Pallas original: it replaces ``stlpose_tpu/ops/nms.py::
_box_nms_topk`` (``box_nms_jax`` with ``max_keep``), a
``jax.lax.fori_loop`` that XLA runs on the TPU as one on-device loop.
In plain PyTorch each pick is ~27 small ops, so the serving paths' two
NMS calls launched thousands of kernels. Bound on the H100: latency, not
bytes; greedy NMS is serial. Design: the JAX package's full formulation
(``box_nms_jax`` without ``max_keep``: a stable sort by score, then a
suppression matrix) cut at ``max_keep`` survivors, which gives the same
mask as the pick-argmax loop. One wrapper call launches three kernels:
a block per image sorts the score keys (CUB's stable block radix sort up
to 32,768 candidates, a bitonic network in the workspace above); blocks
over the whole card write the upper triangle of the sorted candidates'
"IoU > thr" bitmask, 64 bits a word; a block per image scans it in
chunks of 64 candidates (warp 0 resolves a chunk in rounds of one ballot,
while the other warps OR the kept rows' words for the next chunk), then
scatters the keep bits back to candidate order. The workspace (order,
sorted boxes, alive counts, kept rows, B x M x ceil(M / 64) words of
mask) is one ``torch.empty`` per call.

``box_nms_topk`` calls operator ``stlpose::box_nms_topk``
(``kernels/_ops.py``), which launches the kernels for CUDA tensors and
runs ``box_nms_topk_plain`` for CPU tensors. ``LAUNCHES`` counts the
calls that launch (three kernel launches each).
"""

from __future__ import annotations

import ctypes

import torch

from stlpose_tpu_torch.kernels import _build, _ops
from stlpose_tpu_torch.kernels._build import F32, I32, P

LAUNCHES = 0
SYMBOLS = {torch.float32: "nms_f32_launch", torch.bfloat16: "nms_bf16_launch"}


def box_nms_topk_plain(boxes, scores, iou_threshold: float, valid_mask,
                       max_keep: int):
    """Pick-argmax greedy NMS, batched; the plain version of the kernel.

    boxes (B, M, 4) xyxy; scores (B, M); valid_mask (B, M) bool or None.
    Each of ``max_keep`` iterations picks the best alive candidate per
    image (lowest index on ties, as torch.argmax returns the first max),
    keeps it, and removes it and every alive box with IoU above the
    threshold. Returns the (B, M) keep mask: the first ``max_keep`` greedy
    survivors."""
    B, M = scores.shape
    max_keep = min(max_keep, M)
    if valid_mask is None:
        valid_mask = torch.ones_like(scores, dtype=torch.bool)
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    alive = valid_mask & (scores > -torch.inf)
    keep = torch.zeros_like(alive)
    idx = torch.arange(M, device=scores.device)
    neg_inf = torch.tensor(-torch.inf, device=scores.device)
    for _ in range(max_keep):
        i = torch.argmax(torch.where(alive, scores, neg_inf), dim=1,
                         keepdim=True)                              # (B, 1)
        ok = torch.gather(alive, 1, i)                              # (B, 1)
        bx = torch.gather(boxes, 1, i[..., None].expand(B, 1, 4))[:, 0]
        inter = (torch.clamp(torch.minimum(x2, bx[:, 2:3]) -
                             torch.maximum(x1, bx[:, 0:1]), min=0.0) *
                 torch.clamp(torch.minimum(y2, bx[:, 3:4]) -
                             torch.maximum(y1, bx[:, 1:2]), min=0.0))
        area_i = torch.gather(areas, 1, i)
        iou = inter / torch.clamp(areas + area_i - inter, min=1e-9)
        picked = idx[None, :] == i
        keep = keep | (picked & ok)
        # the pick is removed explicitly: a zero-area box has self-IoU 0
        # and would otherwise be picked again on every iteration
        alive = torch.where(ok, alive & ~(iou > iou_threshold) & ~picked,
                            alive)
    return keep


def _box_nms_topk_cuda(boxes, scores, iou_threshold, valid_mask,
                       max_keep):
    """The CUDA implementation of operator ``stlpose::box_nms_topk``."""
    global LAUNCHES
    dev = boxes.device
    B, M = scores.shape[:2] if scores.dim() == 2 else (-1, -1)
    tensors = (boxes, scores) + (() if valid_mask is None else (valid_mask,))
    if (dev.type != "cuda" or boxes.dtype != torch.float32
            or boxes.shape != (B, M, 4) or scores.dtype not in SYMBOLS
            or (valid_mask is not None and (valid_mask.dtype != torch.bool
                                            or valid_mask.shape != (B, M)))
            or any(t.device != dev or not t.is_contiguous()
                   for t in tensors)):
        raise ValueError("box_nms_topk: expected contiguous CUDA float32 "
                         "boxes (B, M, 4), float32 or bfloat16 scores "
                         "(B, M) and bool valid_mask (B, M) or None, all "
                         "on one device")
    if B == 0 or M == 0:
        return torch.zeros((B, M), dtype=torch.bool, device=dev)
    if B > 65535:
        raise ValueError(f"box_nms_topk: at most 65535 images, got {B}")
    keep = torch.empty((B, M), dtype=torch.bool, device=dev)
    workspace_bytes = _build.function("nms", "nms_workspace_bytes",
                                      [I32, I32], ctypes.c_longlong)
    workspace = torch.empty(workspace_bytes(B, M), dtype=torch.uint8,
                            device=dev)
    launch = _build.launcher("nms", SYMBOLS[scores.dtype],
                             [P] * 3 + [I32] * 3 + [F32] + [P] * 3)
    with torch.cuda.device(dev):
        launch(boxes.data_ptr(), scores.data_ptr(),
               None if valid_mask is None else valid_mask.data_ptr(), B, M,
               min(max_keep, M), iou_threshold, keep.data_ptr(),
               workspace.data_ptr(), torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return keep


def _box_nms_topk_fake(boxes, scores, iou_threshold, valid_mask, max_keep):
    return scores.new_empty(scores.shape, dtype=torch.bool)


OP = _ops.define("box_nms_topk(Tensor boxes, Tensor scores, "
                 "float iou_threshold, Tensor? valid_mask, int max_keep) "
                 "-> Tensor",
                 box_nms_topk_plain, _box_nms_topk_cuda, _box_nms_topk_fake)


def box_nms_topk(boxes, scores, iou_threshold: float, valid_mask,
                 max_keep: int):
    """Greedy NMS keep mask; see ``box_nms_topk_plain``. On the card:
    boxes contiguous float32 (B, M, 4), scores contiguous float32 or
    bfloat16 (B, M), valid_mask contiguous bool (B, M) or None; three
    kernel launches per call. Calls operator ``stlpose::box_nms_topk``."""
    return OP(boxes, scores, iou_threshold, valid_mask, max_keep)
