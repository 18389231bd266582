"""K5: pick-argmax greedy NMS (CUDA kernel ``csrc/nms.cu``).

Has no Pallas original: it replaces ``stlpose_tpu/ops/nms.py::
_box_nms_topk`` (``box_nms_jax`` with ``max_keep``), a
``jax.lax.fori_loop`` that XLA runs on the TPU as one on-device loop.
In plain PyTorch each pick is ~27 small ops, so the serving paths' two
NMS calls launched thousands of kernels. Bound on the H100: latency, not
bytes; the picks are serial. Design: the whole loop in one launch, one
block per image, a thread's candidates in registers (shared memory above
3 * 1024, global memory above ``SMEM_CANDIDATES``: a simple branch whose
state lives in the keep mask, for the torchvision-parity training budget
of 6,529), each pick one pass that fuses the previous pick's suppression
with the next argmax, then a block-wide argmax of two ``redux.sync`` per
warp around one barrier; the block stops once nothing is alive.

``box_nms_topk`` launches the kernel for CUDA tensors and runs
``box_nms_topk_plain`` for CPU tensors. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from stlpose_tpu_torch.kernels import _build
from stlpose_tpu_torch.kernels._build import F32, I32, P

LAUNCHES = 0
# 1024 threads x 5 candidates in shared memory (csrc/nms.cu); above, the
# global-memory branch
SMEM_CANDIDATES = 5 * 1024
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


def box_nms_topk(boxes, scores, iou_threshold: float, valid_mask,
                 max_keep: int):
    """Greedy NMS keep mask; see ``box_nms_topk_plain``. On the card:
    boxes contiguous float32 (B, M, 4), scores contiguous float32 or
    bfloat16 (B, M), valid_mask contiguous bool (B, M) or None; one
    launch per call."""
    if boxes.device.type == "cpu":
        return box_nms_topk_plain(boxes, scores, iou_threshold, valid_mask,
                                  max_keep)
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
    keep = torch.empty((B, M), dtype=torch.bool, device=dev)
    launch = _build.launcher("nms", SYMBOLS[scores.dtype],
                             [P] * 3 + [I32] * 3 + [F32] + [P] * 2)
    with torch.cuda.device(dev):
        launch(boxes.data_ptr(), scores.data_ptr(),
               None if valid_mask is None else valid_mask.data_ptr(), B, M,
               min(max_keep, M), iou_threshold, keep.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return keep
