#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stlpose_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--iters 5] [--out DIR]

Phases, each fatal on failure:
  1. print the card (nvidia-smi name, power limit); TF32 off;
  2. build the six CUDA kernel sources from stlpose_tpu_torch/kernels/csrc
     (one nvcc per source, in parallel) and print the build time;
  3. per kernel, at its main path's shapes, compare the kernel with its
     plain PyTorch version on the card; bound = the bytes the function
     must move at 3.35 TB/s (or its f32 operations at 67 TFLOP/s, if
     that is longer); K3q (the int8 quantize pair) exactly, on bf16 and
     f32 pyramids with planted half-steps, an all-zero channel and the
     +-127 ends (at C = 36 its wrapper must refuse the maps); K3 in each
     of its instantiations (f32 ->
     f32, int8 -> bf16, bf16 -> bf16, int8 -> f32), the int8 ones on the
     pyramid of K3q, also on a planted C = 36 scene with elongated P2
     boxes (``odd_roi_scene``);
     K1 and K2 on planted scenes (``decode_scene``, ``warp_scene``,
     ``warp_edge_cases``) that reach every branch of their designs (K1's
     bulk and strided kernels each on the layouts that must take them);
     K4 on three sets of training crops (augmented, all turned by the
     90-degree conditioning, none rotated; ``warp_two_pass_scenes``), on
     uint8 and f32 canvases; K5 (greedy NMS) exactly, at the proposal,
     detection and training-budget shapes (``NMS_SHAPES``, ``nms_scene``:
     level-offset boxes, ties, zero-area boxes on top, dead images) with
     f32 and bf16 scores, with and without a valid mask; its latency
     floor from an empty block-wide argmax round;
  4. drive the fused two-stage serving path end to end at full width
     (Faster R-CNN ResNet50-FPN 400x400 + HRNet-W32 256x192, float32,
     B = 8, seeded random weights) with every launch counter set to 0
     first; check shapes, finiteness, that each kernel was launched (K1
     through its bulk kernel, K5 exactly twice: proposals, detections),
     and agreement with the same program run on the plain versions; time
     images/s and crops/s, then the detector (also with K5's plain loop
     in place, and with NMS stubbed out), HRNet and NMS stages alone;
  4b. the quantized bf16 serving flavor at the same width: seeded
     weights with seeded non-trivial BatchNorm, folded by the port's
     fold_batchnorms; the folded f32 models against the unfolded ones;
     then bf16 compute, folded BatchNorm and the int8 RoI pyramid through
     the same checks as 4 (K1, K2, K3q and K3's int8 -> bf16
     instantiation launched); images/s, crops/s and the drift from the
     f32 flavor on the same weights (a record, not a gate);
  5. drive the pose training path at full width (HRNet-W32 256x192, f32,
     B = 32, Adam lr 1e-3, seeded weights): batches from the device-warp
     collate on seeded 640x640 uint8 canvases with the COCO augmentation
     recipe, train steps, one eval step and one scheduler step, counters
     set to 0 first; check a finite loss, moved parameters and BatchNorm
     statistics, K4 and K1 launched, K1 against its plain version on the
     last timed step's own prediction and target heatmaps, and one step
     on the kernels against the same step on the plain versions (cuDNN
     deterministic: loss, PCK hits and count, every peak, parameters);
     time samples/s and ms per step, split into finalize and step;
  6. under torch.profiler: the device time of each kernel, its plain
     version and (where one exists) the single PyTorch call computing the
     same function, over 20 repeats with the inputs warm in L2, and for
     every kernel and library call also cold (L2 flushed before each
     repeat by rewriting a 256 MB scratch buffer, whose own kernels are
     not counted); one fused call's (f32, which must launch fewer than
     MAX_FUSED_LAUNCHES kernels, and quantized bf16, whose trace must
     hold K3q's and K3's kernels) and one training iteration's
     kernel launches, device busy time and idle share (the bf16 call
     must run no abs/amax/div/round/clamp op on a pyramid level; the
     40 largest
     kernels into DIR/chip_smoke_profile.txt when --out is given).
All host-clock and CUDA-event times are taken before the first profiler
session.
The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
L2_BYTES = 50 << 20            # H100 SXM L2 (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
B, MAX_DETS, BUDGET = 8, 8, 64
# Random weights give person scores spread around 0.5: a threshold of 0
# keeps every valid detection, so 8 per image fill the 64-crop budget.
BBOX_THR = 0.0
# Pose training: batch of stlpose_tpu/config.py, canvas of the device-warp
# pipeline, HRNet's COCO augmentation (scripts/profile_input_pipeline.py)
TRAIN_B, CANVAS, TRAIN_STEPS = 32, 640, 10
AUG = {"dataset": {"scale_factor": 0.35, "rot_factor": 45, "flip": True,
                   "num_joints_half_body": 8, "prob_half_body": 0.3}}
EXP = {"training": {"learning_rate": 1e-3, "optimizer": "adam",
                    "scheduler": "plateau", "learning_rate_factor": 0.1,
                    "patience": 3, "perceptual_loss": True},
       "dataset": {"dataset_name": "styled_coco"}}


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def elapsed_ms(torch, fn, iters):
    """CUDA-event time per call of ``fn`` over ``iters`` back-to-back calls
    after a warm-up call (as the stream sees it, launch gaps included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, iters=1):
    """(kernel launches, summed kernel time in ms) per call of ``fn`` from
    torch.profiler's CUDA trace; (None, None) if the trace holds no device
    events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return None, None
    return (sum(c for _, c, _ in rows) / iters,
            sum(t for t, _, _ in rows) / iters)


def device_rows(prof):
    """[(ms, count, name)] of the device-side events (kernels, copies,
    memsets) of a profile, largest first; CPU-side ops and the device-side
    spans of user annotations (``Optimizer.step#Adam.step`` covers the
    optimizer's kernels and the gaps between them) are left out so no time
    is counted twice."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def bound_ms(n_bytes, flops=0.0):
    """Least time for the work: bytes over HBM rate vs f32 operations over
    the f32 peak, whichever is larger."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


FLUSH_BYTES = 256 << 20        # scratch rewritten between cold repeats


def l2_flush(torch):
    """A function that rewrites a FLUSH_BYTES scratch buffer (over 2 x the
    H100's 50 MB L2), evicting whatever the cache held."""
    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda")
    return lambda: scratch.fill_(1.0)


def cold_elapsed_ms(torch, fn, flush, iters):
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, L2 flushed
    before each; the events bracket ``fn`` alone, not the flush."""
    fn()
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def event_times(torch, fns, iters=20, cold=False):
    """``<x>events_ms``: CUDA-event time per call of each timed function
    (``fns``: label -> function or None; "" the kernel, "plain_" its plain
    version, "library_" the library call, others the kernel at other
    inputs), launch gaps and host overhead included; with ``cold``, also
    ``<x>cold_events_ms`` of all but the plain version, L2 flushed before
    each call. Taken before any profiler session."""
    rec = {label + "events_ms": None if fn is None else
           elapsed_ms(torch, fn, iters) for label, fn in fns.items()}
    if cold:
        flush = l2_flush(torch)
        for label, fn in fns.items():
            if fn is not None and label != "plain_":
                rec[label + "cold_events_ms"] = cold_elapsed_ms(
                    torch, fn, flush, iters)
    return rec


def device_profile_cold(torch, fn, flush, iters=20, attempts=3):
    """Summed device time per call of ``fn`` with L2 flushed before each
    of ``iters`` calls, from torch.profiler's trace, leaving out the
    flush's own kernels (PyTorch's fill kernel, which none of the timed
    functions launches). A trace that holds no flush or no other device
    event is taken again, up to ``attempts`` times (the profiler now and
    then returns one without device events); None after that."""
    from torch.profiler import ProfilerActivity, profile
    flush()
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        timed = [t for t, _, k in rows if "FillFunctor" not in k]
        if timed and len(timed) < len(rows):
            return sum(timed) / iters
    return None


def device_times(torch, rec, fns, iters=20):
    """``<x>ms``: the summed device time of the kernels one call launches
    (torch.profiler, warm: the inputs stay in L2 between calls), or the
    CUDA-event time where the trace holds no device events; where
    ``<x>cold_events_ms`` was taken, ``<x>cold_ms`` likewise with L2
    flushed before each of ``iters`` calls."""
    flush = None
    for label, fn in fns.items():
        dv = None if fn is None else device_profile(torch, fn, iters)[1]
        rec[label + "ms"] = rec[label + "events_ms"] if dv is None else dv
        if label + "cold_events_ms" in rec:
            flush = flush or l2_flush(torch)
            dv = device_profile_cold(torch, fn, flush, iters)
            rec[label + "cold_ms"] = (rec[label + "cold_events_ms"]
                                      if dv is None else dv)


# ------------------------------------------------------------------ kernels
def decode_scene(torch, dev, rng, N=BUDGET, J=17, H=64, W=48):
    """(N, J, H, W) f32 maps, NCHW memory as HRNet writes it (N >= 4,
    J >= 12), uniform in [-0.5, 1), with planted cases, and {(n, j): (x,
    y)} the peaks that they must give. Ties sit at each merge boundary of
    K1's bulk kernel at 64x48 (128 threads, thread t taking float4 t,
    t + 128, ...): inside one float4, across lanes, across warps, between
    one thread's loads, in the last float4; also an all-negative map, a crop
    <= 0, an all-zero and a constant map (every index ties), peaks on and
    next to the border, and flat neighbours (sign 0)."""
    hm = torch.rand((N, J, H, W), generator=rng, device=dev) * 1.5 - 0.5
    flat = hm.view(N, J, H * W)
    ties = {1: (175, 247),          # rows 3 and 5
            2: (31, 32),            # lanes 7 and 8
            3: (101, 102),          # inside one float4
            4: (127, 128),          # warp 0 lane 31, warp 1 lane 0
            5: (511, 512),          # warp 3 lane 31, thread 0's 2nd float4
            6: (23, 532),           # one thread's 1st and 2nd float4
            7: (767, 768),          # threads 63 and 64, 6th and 7th float4
            8: (3068, 3071),        # the last float4
            9: (500, 1000, 2000)}
    expect = {}
    for j, idx in ties.items():
        for i in idx:
            flat[0, j, i] = 2.0 + j
        expect[(0, j)] = (float(min(idx) % W), float(min(idx) // W))
    flat[0, 10, H * W - 1] = 3.0                      # last value alone
    flat[0, 11, H * W - 2] = 3.0
    expect[(0, 10)] = (W - 1.0, H - 1.0)
    expect[(0, 11)] = (W - 2.0, H - 1.0)
    hm[0, 0] = -hm[0, 0].abs() - 0.1                  # all negative
    expect[(0, 0)] = (0.0, 0.0)
    hm[1] = -hm[1].abs()                              # whole crop <= 0
    hm[2, 0] = 0.0                                    # all zero (targets)
    hm[2, 1] = 0.5                                    # constant: index 0
    expect[(2, 1)] = (0.0, 0.0)
    for j, (y, x) in {3: (0, 0), 4: (H - 1, W - 1), 5: (1, 20),
                      6: (30, W - 2), 7: (20, 20)}.items():
        hm[2, j, y, x] = 3.0
        expect[(2, j)] = (float(x), float(y))
    hm[2, 7, 20, 19] = hm[2, 7, 20, 21] = 1.0         # flat neighbours
    hm[2, 7, 19, 20] = hm[2, 7, 21, 20] = 1.0
    return hm, expect


def peaks_err(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def check_decode(torch, k1, dev, rng):
    """K1 at (64 crops, 17 joints, 64x48) on ``decode_scene``: the bulk
    kernel over all the maps and over 191 x 13 of them (2,483 maps: 13 of
    each crop's 17, a strided batch of contiguous maps); the strided kernel on an NHWC-memory view and
    on a view 4 bytes off alignment. Exact agreement with the plain
    version required, and the planted peaks."""
    N, J, H, W = BUDGET, 17, 64, 48
    hm, expect = decode_scene(torch, dev, rng)
    ref = k1.heatmap_peaks_plain(hm)
    nhwc = hm.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    shifted = torch.empty(hm.numel() + 1, device=dev)
    shifted[1:] = hm.reshape(-1)
    unaligned = shifted[1:].view(N, J, H, W)
    part = torch.cat([hm] * 3)[:-1, :13]
    part_ref = k1.heatmap_peaks_plain(part)
    cases = {"bulk": (hm, "bulk", ref),
             "bulk_2483_maps": (part, "bulk", part_ref),
             "strided_nhwc_view": (nhwc, "strided", ref),
             "strided_unaligned_view": (unaligned, "strided", ref)}
    errs = {}
    for name, (x, kernel, r) in cases.items():
        before = k1.LAUNCHES_BY_KERNEL[kernel]
        got = k1.heatmap_peaks(x)
        torch.cuda.synchronize()
        if k1.LAUNCHES_BY_KERNEL[kernel] != before + 1:
            fail(f"K1 case {name} did not take the {kernel} kernel")
        errs[name] = peaks_err(got, r)
        wrong = {nj: xy for nj, xy in expect.items()
                 if tuple(got[0][nj].tolist()) != xy}
        if wrong:
            fail(f"K1 case {name}: planted peaks wrong at {wrong}")
    err = max(errs.values())
    if err != 0.0:
        fail(f"K1 decode differs from its plain version: {errs}")
    flat = hm.reshape(N, J, H * W)
    n_bytes = hm.numel() * 4 + N * J * 5 * 4
    b, by = bound_ms(n_bytes, flops=hm.numel())
    fns = {"": lambda: k1.heatmap_peaks(hm),
           "plain_": lambda: k1.heatmap_peaks_plain(hm),
           "library_": lambda: torch.max(flat, dim=-1)}
    return dict(name="heatmap_peaks", route="cuda",
                source="stlpose_tpu_torch/kernels/csrc/decode.cu",
                replaces="stlpose_tpu/ops/pallas_decode.py:74",
                max_abs_err=err, tolerance=0.0, case_errs=errs,
                bound_ms=b, bound_by=by, shape=[N, J, H, W],
                **event_times(torch, fns, cold=True)), fns


def warp_scene(torch, affine, dev, rng, n_img=B, S=400, K=BUDGET,
               out_wh=(192, 256)):
    """K2's serving inputs: K unrotated crops of ``out_wh`` from ``n_img``
    random S x S x 3 images on the 0-255 scale, centres from S/10 outside
    the image to inside, boxes partly outside. Returns images, centers,
    scales, img_idx (int32) and params (K, 4): (a, b, tx, ty) of the
    inverse map, as ``ops/warp.py`` computes them."""
    images = torch.rand((n_img, S, S, 3), generator=rng, device=dev) * 255.0
    u = torch.rand((K, 4), generator=rng, device=dev)
    centers = torch.stack([u[:, 0] * 1.2 * S - 0.1 * S,
                           u[:, 1] * 1.2 * S - 0.1 * S], -1)
    scales = torch.stack([0.2 + 1.6 * u[:, 2], 0.3 + 2.0 * u[:, 3]],
                         -1) * (S / 400.0)
    img_idx = torch.randint(0, n_img, (K,), generator=rng, device=dev,
                            dtype=torch.int32)
    params = warp_params(torch, affine, centers, scales,
                         torch.zeros(K, device=dev), out_wh)
    return images, centers, scales, img_idx, params


def warp_params(torch, affine, centers, scales, rot, out_wh):
    return torch.stack(affine.get_affine_params(centers, scales, rot, out_wh,
                                                inv=True), -1).contiguous()


ROTATIONS = (30.0, -30.0, 60.0, -60.0, 90.0)


def warp_edge_cases(torch, affine, scene, out_wh):
    """Eight crops beside the serving scene: the scene's first five crops
    (cycled if it has fewer) rotated by ROTATIONS, one centred far outside its image, and two whose
    img_idx is -1 and B (both must read zeros only). Returns centers,
    scales, rot, img_idx and params."""
    images, centers, scales, img_idx, _ = scene
    n_img, S = images.shape[0], images.shape[1]
    dev = images.device
    sel = torch.arange(len(ROTATIONS) + 3, device=dev) % centers.shape[0]
    centers = centers[sel]
    centers[-3:] = torch.tensor([[-3.0 * S, -3.0 * S], [S / 2, S / 2],
                                 [S / 2, S / 2]], device=dev)
    rot = torch.tensor(ROTATIONS + (0.0, 0.0, 0.0), device=dev)
    idx = img_idx[sel]
    idx[-3:] = torch.tensor([0, -1, n_img], device=dev, dtype=torch.int32)
    scales = scales[sel]
    return centers, scales, rot, idx, warp_params(torch, affine, centers,
                                                  scales, rot, out_wh)


def check_warp(torch, k2, affine, affine_warp, dev, rng):
    """K2: K = 64 crops of 256x192 from B = 8 images of 400x400, boxes
    partly outside the image; then the edge cases of ``warp_edge_cases``
    at 192x256 and at 190x250 (a width that is no multiple of 4, so no
    bulk band store), the rotated ones also through ``ops/warp.py::
    affine_warp``, and a 2-channel copy of the images (the any-C loop) at
    both sizes. Tolerance 1e-3 on the 0-255 scale (0.0 expected)."""
    import torch.nn.functional as F
    S = 400
    scene = warp_scene(torch, affine, dev, rng)
    images, _, _, img_idx, params = scene
    a, bb, tx, ty = params.unbind(-1)
    ref = k2.affine_crop_plain(images, params, img_idx, (192, 256))
    errs = {"serving": float((k2.affine_crop(images, params, img_idx,
                                             (192, 256)) - ref).abs().max())}
    if not 0.01 < float((ref == 0).float().mean()) < 0.99:
        fail("K2 check boxes do not straddle the image border")
    for out_wh in ((192, 256), (190, 250)):
        centers, scales, rot, idx, p_e = warp_edge_cases(torch, affine,
                                                         scene, out_wh)
        ref_e = k2.affine_crop_plain(images, p_e, idx, out_wh)
        if bool(ref_e[-3:].any()) or not bool(ref_e[:-3].any()):
            fail("K2 edge cases: a crop outside its image or with a bad "
                 "index read non-zeros, or the rotated crops read zeros")
        tag = f"{out_wh[0]}x{out_wh[1]}"
        errs[f"edge_{tag}"] = float(
            (k2.affine_crop(images, p_e, idx, out_wh) - ref_e).abs().max())
        n = len(ROTATIONS)
        rotated = affine_warp(images[idx[:n].long()], centers[:n],
                              scales[:n], rot[:n], out_wh)
        errs[f"affine_warp_rotated_{tag}"] = float(
            (rotated - ref_e[:n]).abs().max())
        two = images[..., :2].contiguous()
        errs[f"two_channels_{tag}"] = float((
            k2.affine_crop(two, params, img_idx, out_wh) -
            k2.affine_crop_plain(two, params, img_idx, out_wh)).abs().max())
    err = max(errs.values())
    if not err <= 1e-3:
        fail(f"K2 warp differs from its plain version: {errs}")
    # library yardstick: grid_sample on the gathered images
    gathered = images[img_idx.long()].permute(0, 3, 1, 2).contiguous()
    gy, gx = torch.meshgrid(torch.arange(256., device=dev),
                            torch.arange(192., device=dev), indexing="ij")
    sx = a[:, None, None] * gx - bb[:, None, None] * gy + tx[:, None, None]
    sy = bb[:, None, None] * gx + a[:, None, None] * gy + ty[:, None, None]
    grid = torch.stack([sx * (2.0 / (S - 1)) - 1.0,
                        sy * (2.0 / (S - 1)) - 1.0], -1)
    lib_out = F.grid_sample(gathered, grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_err = float((lib_out.permute(0, 2, 3, 1) - ref).abs().max())
    n_imgs = int(torch.unique(img_idx).numel())
    n_bytes = ref.numel() * 4 + n_imgs * S * S * 3 * 4 + BUDGET * 20
    b, by = bound_ms(n_bytes, flops=ref.numel() * 7 + ref.numel() / 3 * 20)
    fns = {"": lambda: k2.affine_crop(images, params, img_idx, (192, 256)),
           "plain_": lambda: k2.affine_crop_plain(images, params, img_idx,
                                                  (192, 256)),
           "library_": lambda: F.grid_sample(
               gathered, grid, mode="bilinear", padding_mode="zeros",
               align_corners=True)}
    return dict(name="affine_crop", route="cuda",
                source="stlpose_tpu_torch/kernels/csrc/warp.cu",
                replaces="stlpose_tpu/ops/pallas_warp.py:235",
                max_abs_err=err, tolerance=1e-3, case_errs=errs,
                bound_ms=b, bound_by=by, library_max_abs_err=lib_err,
                shape=[B, S, S, 3, BUDGET, 256, 192],
                **event_times(torch, fns, cold=True)), fns


# one f32 fused call launched 10,716 kernels with NMS as a per-pick chain
# of PyTorch ops (PR 5); with K5 about 2,000
MAX_FUSED_LAUNCHES = 3000
ROI_SIZES, ROI_P, ROI_C, ROI_STRIDES = (100, 50, 25, 13), 256, 256, (4, 8, 16, 32)
# K3's record names by instantiation (pyramid type _ output type)
ROI_RECORDS = {"f32_f32": "roi_align", "i8_bf16": "roi_align_i8_bf16",
               "bf16_bf16": "roi_align_bf16_bf16", "i8_f32": "roi_align_i8_f32"}
# the PyTorch ops of quantize_levels_plain: none may touch a pyramid level
# in the bf16 call, whose quantization is K3q's
QUANTIZE_OPS = ("aten::abs", "aten::amax", "aten::div", "aten::round",
                "aten::clamp", "aten::clamp_min")


def roi_scene(torch, roi_ops, dev, rng):
    """K3's inputs at the serving path's shapes: B = 8, P = 256 boxes per
    image, C = 256 f32 maps P2..P5 of 100/50/25/13; random boxes plus
    extreme-aspect, degenerate and far-edge level-2 boxes, 16 boxes per
    image forced onto P5 and one onto no level."""
    S = 400
    feats = [torch.randn((B, s, s, ROI_C), generator=rng, device=dev)
             for s in ROI_SIZES]
    u = torch.rand((B, ROI_P, 4), generator=rng, device=dev)
    x1, y1 = u[..., 0] * (S - 2), u[..., 1] * (S - 2)
    boxes = torch.stack([x1, y1, torch.clamp(x1 + 1 + u[..., 2] * S, max=S),
                         torch.clamp(y1 + 1 + u[..., 3] * S, max=S)], -1)
    special = torch.tensor([
        [0.0, 0.0, S - 1.0, 10.0], [S - 20.0, 0.0, S, S], [0.0, 0.0, S, S],
        [0.0, 100.0, S, 130.0], [10.0, 10.0, 11.0, 11.0], [5.0, 5.0, 5.0, 5.0],
        [370.0, 250.0, 400.0, 295.0], [170.0, 390.0, 280.0, 400.0],
        [380.0, 295.0, 400.0, 400.0], [360.0, 80.0, 400.0, 225.0],
        [390.0, 390.0, 400.0, 400.0], [0.0, 370.0, 45.0, 400.0]],
        device=dev)
    boxes[:, :len(special)] = special
    levels = roi_ops._assign_levels(boxes, 4)
    # a 400-px canvas never assigns P5 (sqrt(area) < 448): pool the last
    # 16 boxes of each image from it anyway, and one box from no level
    # (its output must be zeros), so every branch of the kernel runs
    levels[:, -17:-1] = 3
    levels[:, -1] = -1
    return feats, boxes, levels


def odd_roi_scene(torch, roi_ops, dev, rng, C=36):
    """A planted K3 case beside ``roi_scene``: C = 36 channels (no
    multiple of 16: K3's bf16 and int8 lanes read one channel at a time,
    its f32 lanes end in a part-filled slice) on two images of the
    serving levels, with elongated P2 boxes spanning the whole level in x
    or in y, random boxes, and one box on no level."""
    S = 400
    feats = [torch.randn((2, s, s, C), generator=rng, device=dev)
             for s in ROI_SIZES]
    u = torch.rand((2, 12, 4), generator=rng, device=dev)
    x1, y1 = u[..., 0] * (S - 40), u[..., 1] * (S - 40)
    boxes = torch.stack([x1, y1, x1 + 5 + u[..., 2] * 200,
                         y1 + 5 + u[..., 3] * 200], -1)
    boxes[:, :4] = torch.tensor([[0.0, 100.0, S, 130.0],
                                 [100.0, 0.0, 130.0, S],
                                 [-20.0, 380.0, 420.0, 405.0],
                                 [3.0, 7.0, 5.0, 399.0]], device=dev)
    levels = roi_ops._assign_levels(boxes, 4)
    levels[:, -1] = -1
    if not bool((levels[:, :4] == 0).all()):
        fail("K3 odd-C scene: the elongated boxes are not on P2")
    return feats, boxes, levels


def check_roi_variant(torch, k3, k3q, roi_ops, scene, odd, variant):
    """One K3 instantiation on the scene of ``roi_scene`` and on the
    planted ``odd_roi_scene``: the f32 maps as they are (f32_f32), rounded
    to bf16 (bf16_bf16), or quantized from the f32 maps (i8_f32) or from
    their bf16 rounding (i8_bf16, the quantized bf16 serving path) by the
    path's own ``quantize_levels`` (K3q, checked before; at C = 36, which
    K3q refuses, by its plain version). Kernel and plain
    version run the same f32 operations in the same order and round once,
    so 0.0 is required; f32_f32 keeps its earlier 1e-5. Timed warm and
    cold on ``roi_scene``."""
    src, out_name = variant.split("_")
    out_dtype = torch.bfloat16 if out_name == "bf16" else torch.float32
    tol = 1e-5 if variant == "f32_f32" else 0.0
    errs = {}
    for case, (feats, boxes, levels) in (("odd_c_elongated", odd),
                                         ("serving", scene)):
        maps = [f.to(out_dtype) for f in feats]
        scales = None
        if src == "i8":
            maps, scales = (roi_ops.quantize_levels if case == "serving"
                            else k3q.quantize_levels_plain)(maps)
        args = (maps, boxes, levels, ROI_STRIDES, scales, out_dtype)
        got = k3.roi_align(*args)
        ref = k3.roi_align_plain(*args)
        if got.dtype != out_dtype:
            fail(f"K3 {variant} returned {got.dtype}")
        errs[case] = float((got.float() - ref.float()).abs().max())
        if bool(got[:, -1].any()) or not bool(got[:, :-1].any()):
            fail(f"K3 RoIAlign {variant} {case}: a level -1 box did not pool "
                 f"zeros, or every other box did")
    err = max(errs.values())
    if not err <= tol:
        fail(f"K3 RoIAlign {variant} differs from its plain version: {errs}")
    if not bool(got[:, -17:-1].any()):      # the serving scene's P5 boxes
        fail(f"K3 RoIAlign {variant}: P5 boxes pooled zeros")
    n_bytes = (got.numel() * got.element_size() +
               sum(m.numel() * m.element_size() for m in maps) +
               boxes.numel() * 4 + levels.numel() * 4 +
               (0 if scales is None else scales.numel() * 4))
    # per output: 4 samples x (4 taps x 2 flops + 3 weights) + the mean
    # (+ the dequantization multiply)
    b, by = bound_ms(n_bytes, flops=got.numel() * (4 * 12 + (src == "i8")))
    fns = {"": lambda: k3.roi_align(*args),
           "plain_": lambda: k3.roi_align_plain(*args), "library_": None}
    rec = dict(name=ROI_RECORDS[variant], route="cuda",
               source="stlpose_tpu_torch/kernels/csrc/roi_align.cu",
               replaces=("stlpose_tpu/ops/pallas_roi.py:286" if src != "i8"
                         else "stlpose_tpu/ops/pallas_roi.py:417"),
               instantiation=variant, max_abs_err=err, tolerance=tol,
               case_errs=errs, bound_ms=b, bound_by=by, bytes=n_bytes,
               level_counts=[int((levels == i).sum()) for i in range(4)],
               shape=[B, ROI_P, ROI_C, *ROI_SIZES],
               **event_times(torch, fns, cold=True))
    return rec, fns


def quantize_cases(torch, feats):
    """Planted values on (copies of) the serving maps: on P2 channel 0 an
    absmax of 127 (scale 1.0) beside the half-steps +-0.5, +-2.5, 1.5 and
    126.5 and the ends +-127; on P3 an all-zero channel (the 1e-8 floor);
    on P4 a channel of +-3e-9 (under the floor: quantized to +-38); on P5
    a channel whose absmax sits at both signs. Returns the maps and the
    planted (level, index, int8) values."""
    feats = [f.clone() for f in feats]
    feats[0][0, 0, :8, 0] = torch.tensor(
        [127.0, 2.5, -2.5, 0.5, -0.5, 1.5, 126.5, -127.0],
        device=feats[0].device)
    feats[1][..., 5] = 0.0
    feats[2][..., 6] = torch.where(feats[2][..., 6] > 0, 3e-9, -3e-9)
    feats[3][0, 0, 0, 7], feats[3][0, 1, 0, 7] = 9.0, -9.0
    expect = [(0, (0, 0, slice(0, 8), 0), [127, 2, -2, 0, 0, 2, 126, -127]),
              (3, (0, 0, 0, 7), 127), (3, (0, 1, 0, 7), -127)]
    return feats, expect


def check_quantize(torch, k3q, scene, odd):
    """K3q on the serving pyramid (B = 8, C = 256, P2-P5 of 100/50/25/13)
    in bf16 (the quantized bf16 serving path's input) and in f32 (what
    i8_f32 pools), with the planted values of ``quantize_cases``: int8
    levels and scales equal to ``quantize_levels_plain``. The C = 36 maps
    of ``odd_roi_scene`` (no 16-byte int8 store per pixel) must raise.
    Timed warm and cold on the bf16 pyramid beside
    ``torch.linalg.vector_norm`` (inf) per level, the absmax half."""
    planted, expect = quantize_cases(torch, scene[0])
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        maps = [f.to(dtype) for f in planted]
        q, s = k3q.quantize_levels(maps)
        rq, rs = k3q.quantize_levels_plain(maps)
        bad = [i for i, (a, b) in enumerate(zip(q, rq))
               if a.dtype != torch.int8 or not torch.equal(a, b)]
        if bad or not torch.equal(s, rs):
            fail(f"K3q {dtype}: int8 levels {bad} or the scales differ "
                 f"from the plain version")
        wrong = [(lv, v) for lv, idx, v in expect if q[lv][idx].tolist() != v]
        if wrong or float(s[0, 0]) != 1.0 or bool(q[1][..., 5].any()):
            fail(f"K3q planted values wrong: {wrong}")
        errs[f"serving_{str(dtype)[6:]}"] = 0.0
        try:
            k3q.quantize_levels([f.to(dtype) for f in odd[0]])
        except ValueError:
            pass
        else:
            fail(f"K3q took C = 36 {dtype} maps it has no kernel for")
    maps = [f.to(torch.bfloat16) for f in scene[0]]
    n_el = sum(m.numel() for m in maps)
    L, C = len(maps), maps[0].shape[-1]
    # the pyramid read once, again what the L2 cannot keep for the second
    # pass, the int8 pyramid and the scales written, the absmax buffer
    # written and read
    n_bytes = (n_el * 2 + max(0, n_el * 2 - L2_BYTES) + n_el +
               2 * L * C * 4)
    # per element: |x|, max, the division, rint, two clamps
    b, by = bound_ms(n_bytes, flops=n_el * 6)
    fns = {"": lambda: k3q.quantize_levels(maps),
           "plain_": lambda: k3q.quantize_levels_plain(maps),
           "library_": lambda: [torch.linalg.vector_norm(
               m, float("inf"), dim=(0, 1, 2)) for m in maps]}
    return dict(name="quantize_levels", route="cuda",
                source="stlpose_tpu_torch/kernels/csrc/quantize.cu",
                replaces="stlpose_tpu/ops/pallas_roi.py:422",
                max_abs_err=0.0, tolerance=0.0, case_errs=errs,
                bound_ms=b, bound_by=by, bytes=n_bytes,
                library="torch.linalg.vector_norm(inf) per level (absmax "
                        "half only)",
                shape=[B, ROI_C, *ROI_SIZES],
                **event_times(torch, fns, cold=True)), fns


def synthetic_records(mods, seed):
    """TRAIN_B seeded uint8 images of CANVAS x CANVAS (the letterbox size,
    so the pipeline needs no cv2 for them) and one person record on each:
    a random box, 17 joints inside it (80% visible), a perceptual loss."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (TRAIN_B, CANVAS, CANVAS, 3), np.uint8)
    recs = []
    for i in range(TRAIN_B):
        w, h = rng.uniform(80, 300), rng.uniform(150, 450)
        x, y = rng.uniform(0, CANVAS - w), rng.uniform(0, CANVAS - h)
        c, sc = mods["xywh_to_cs"](x, y, w, h)
        joints = np.stack([x + rng.rand(17) * w, y + rng.rand(17) * h],
                          -1).astype(np.float32)
        recs.append(mods["PoseRecord"](
            image=f"synthetic_{i}", original_image=f"synthetic_{i}",
            image_id=i, center=c, scale=sc, joints=joints,
            joints_vis=(rng.rand(17) > 0.2).astype(np.float32),
            perceptual_loss=float(rng.rand())))
    return images, recs


def two_pass_footprint(torch, params, S, out_hw):
    """Canvas pixels, over the batch, that the two-pass warp's in-bounds
    taps read (each read once: the bound's input bytes)."""
    N = params.shape[0]
    DH, DW = out_hw
    dev = params.device
    gy = torch.arange(DH, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(DW, dtype=torch.float32, device=dev)[None, :]
    u, r, txr, b, a, ty, swap = (params[:, i, None, None] for i in range(7))
    n = torch.arange(N, device=dev)[:, None, None]
    seen = torch.zeros(N * S * S, dtype=torch.bool, device=dev)
    y0 = torch.floor(b * gx + a * gy + ty)
    for y in (y0, y0 + 1):
        x0 = torch.floor(u * gx - r * y + txr)
        for x in (x0, x0 + 1):
            ok = (y >= 0) & (y < S) & (x >= 0) & (x < S)
            yi, xi = y.clamp(0, S - 1).long(), x.clamp(0, S - 1).long()
            row = torch.where(swap > 0, xi, yi)
            col = torch.where(swap > 0, S - 1 - yi, xi)
            seen[((n * S + row) * S + col)[ok]] = True
    return int(seen.sum())


def warp_two_pass_scenes(torch, mods, dev, seed):
    """K4's training inputs: TRAIN_B seeded uint8 canvases of 640x640 and
    three sets of crops on them: ``augmented`` (the port's
    AugmentationParams with the COCO recipe, four forced to +-60 and +-89
    degrees so the conditioning turn runs), ``all_turned`` (the same
    crops at 50-130 degrees either way: every crop turned) and
    ``unrotated`` (the same crops at 0 degrees). Returns the canvases,
    {scene: (centers, scales, rot, params)}."""
    images, recs = synthetic_records(mods, seed)
    aug = mods["AugmentationParams"](
        scale_factor=0.35, rotation_factor=45, flip=True,
        prob_half_body=0.3, seed=seed)
    draws = [aug.sample(r.center, r.scale, r.joints, r.joints_vis)
             for r in recs]
    rots = np.float32([d[2] for d in draws])
    rots[:4] = (60.0, -60.0, 89.0, -89.0)
    rng = np.random.RandomState(seed)
    turned = (rng.uniform(50.0, 130.0, TRAIN_B) *
              np.where(np.arange(TRAIN_B) % 2, 1.0, -1.0)).astype(np.float32)
    canv = torch.from_numpy(images).to(dev)
    centers = torch.from_numpy(np.stack([d[0] for d in draws])).to(dev)
    scales = torch.from_numpy(np.stack([d[1] for d in draws])).to(dev)
    scenes = {}
    for name, r in (("augmented", rots), ("all_turned", turned),
                    ("unrotated", np.zeros_like(rots))):
        rot = torch.from_numpy(r).to(dev)
        scenes[name] = (centers, scales, rot, mods["two_pass_params"](
            centers, scales, rot, CANVAS, (192, 256)))
    return canv, scenes


def check_warp_two_pass(torch, k4, mods, dev, seed):
    """K4 at the training shapes on the scenes of ``warp_two_pass_scenes``,
    each on the uint8 canvases and on the same canvases as f32 (uint8 ->
    f32 is exact). Tolerance 1e-4 on the 0-255 scale (0 expected: kernel
    and plain version round alike). Timed warm and cold on every scene
    (``all_turned_ms``, ...), the record's ``ms`` on ``augmented``."""
    canv, scenes = warp_two_pass_scenes(torch, mods, dev, seed)
    errs = {}
    for name, (_, _, _, params) in scenes.items():
        ref = k4.warp_two_pass_plain(canv, params, (192, 256))
        for cv, tag in ((canv, "u8"), (canv.float(), "f32")):
            errs[f"{name}_{tag}"] = float(
                (k4.warp_two_pass(cv, params, (192, 256)) - ref).abs().max())
    err = max(errs.values())
    if not err <= 1e-4:
        fail(f"K4 two-pass warp differs from its plain version: {errs}")
    swaps = {n: int(sc[3][:, 6].sum()) for n, sc in scenes.items()}
    if (swaps["augmented"] < 4 or swaps["all_turned"] != TRAIN_B
            or swaps["unrotated"] or bool(scenes["unrotated"][3][:, 3].any())):
        fail(f"K4 scenes: crops turned {swaps}, or an unrotated crop has "
             f"b != 0")
    centers, scales, rot, params = scenes["augmented"]
    # K2 (direct bilinear) on the same crops: a different function
    ref = k4.warp_two_pass_plain(canv, params, (192, 256))
    k2_diff = float((mods["affine_warp"](canv.float(), centers, scales, rot,
                                         (192, 256)) - ref).abs().max())
    touched = two_pass_footprint(torch, params, CANVAS, (256, 192))
    n_bytes = ref.numel() * 4 + touched * 3 + params.numel() * 4
    b, by = bound_ms(n_bytes, flops=ref.numel() * 15)
    fns = {"": lambda: k4.warp_two_pass(canv, params, (192, 256)),
           "plain_": lambda: k4.warp_two_pass_plain(canv, params,
                                                    (192, 256)),
           "library_": None}
    for n, sc in scenes.items():
        if n != "augmented":
            fns[n + "_"] = lambda p=sc[3]: k4.warp_two_pass(canv, p,
                                                             (192, 256))
    return dict(name="warp_two_pass", route="cuda",
                source="stlpose_tpu_torch/kernels/csrc/warp_two_pass.cu",
                replaces="stlpose_tpu/ops/pallas_warp.py:156",
                max_abs_err=err, tolerance=1e-4, case_errs=errs,
                bound_ms=b, bound_by=by, crops_turned=swaps,
                canvas_bytes_read=touched * 3,
                k2_direct_bilinear_max_abs_diff=k2_diff,
                shape=[TRAIN_B, CANVAS, CANVAS, 3, 256, 192],
                **event_times(torch, fns, cold=True)), fns


# (label, candidates per FPN level, picks, IoU threshold): the proposal NMS
# of the serving path (pre_nms_top_n_test 500 on P2-P5, all 147 anchors of
# P6 at 400x400), its detection NMS (post_nms 256 proposals,
# detections_per_img 64), and the training budget of the reference
# (stlpose_tpu/models/faster_rcnn.py:58-60, pre_nms_top_n_train 1000)
NMS_SHAPES = (("proposal", (500, 500, 500, 500, 147), 256, 0.7),
              ("detection", (256,), 64, 0.5),
              ("train", (1000, 1000, 1000, 1000, 147), 512, 0.7))


def nms_scene(torch, dev, g, levels, image=400.0):
    """B = 8 images of candidates as the detector makes them: per level
    random boxes on a 400x400 canvas shifted apart by level * 800
    (``select_proposals``' offset), random logits as scores, ``valid`` the
    boxes of positive size. Planted: image 0 duplicated boxes with tied
    scores, zero-area boxes on top, -0.0 beside +0.0, an IoU of exactly
    0.5; image 1 every score -inf; image 2 nothing valid; image 3 ten
    alive candidates. Returns boxes (8, M, 4), f32 scores, valid."""
    M = sum(levels)
    lvl = torch.cat([torch.full((n,), float(i)) for i, n in
                     enumerate(levels)])
    xy = torch.rand((B, M, 2), generator=g) * image
    wh = torch.rand((B, M, 2), generator=g) * 80.0
    boxes = torch.cat([xy, torch.clamp(xy + wh, max=image)], -1)
    boxes[:, ::97, 2] = boxes[:, ::97, 0]               # zero width
    scores = torch.randn((B, M), generator=g)
    boxes[0, 10:14] = boxes[0, 10]                      # duplicates, tied
    scores[0, 10:14] = 5.0
    boxes[0, 20:24, 2:] = boxes[0, 20:24, :2]           # zero area, on top
    scores[0, 20:24] = torch.tensor([9.0, 8.5, 8.5, 8.0])
    scores[0, 30], scores[0, 31] = -0.0, 0.0
    boxes[0, 40] = torch.tensor([0.0, 0.0, 2.0, 2.0])   # IoU exactly 0.5
    boxes[0, 41] = torch.tensor([0.0, 0.0, 2.0, 1.0])
    scores[0, 40:42] = torch.tensor([7.0, 6.5])
    boxes = boxes + lvl[None, :, None] * (image * 2.0)
    valid = ((boxes[..., 2] - boxes[..., 0]) >= 1e-3) & \
        ((boxes[..., 3] - boxes[..., 1]) >= 1e-3)
    valid[0, 20:24] = True
    scores = torch.where(valid, scores, -torch.inf)
    scores[1] = -torch.inf
    valid[2] = False
    valid[3] = False
    valid[3, torch.randperm(M, generator=g)[:10]] = True
    return boxes.to(dev), scores.to(dev), valid.to(dev)


def argmax_round_ms(torch, dev, threads, blocks=B):
    """Device ms of one empty block-wide argmax round of K5 (the loop's
    barrier and reductions, no candidates): ``blocks`` blocks of
    ``threads``, 1100 rounds against 100 rounds, CUDA events."""
    from stlpose_tpu_torch.kernels import _build
    from stlpose_tpu_torch.kernels._build import I32, P
    launch = _build.launcher("nms", "nms_argmax_rounds_launch",
                             [I32] * 3 + [P, P])
    out = torch.empty(blocks, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    t = {r: elapsed_ms(torch, lambda: launch(threads, blocks, r,
                                             out.data_ptr(), stream), 20)
         for r in (100, 1100)}
    return (t[1100] - t[100]) / 1000


def check_nms(torch, k5, dev, seed):
    """K5 at the three NMS shapes (``NMS_SHAPES``) on ``nms_scene``, with
    f32 and bf16 scores, with ``valid`` and with None: keep masks equal to
    ``box_nms_topk_plain``'s, and the planted cases as greedy NMS must
    give them. Timed warm and cold at each shape (f32 scores:
    ``detection_ms``, ...), the record's ``ms`` at the proposal shape;
    bound from bytes, and beside it the latency floor: the picks of the
    longest image times one empty block-wide argmax round on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    scenes, errs, extra = {}, {}, {}
    for label, levels, keep, thr in NMS_SHAPES:
        boxes, scores, valid = nms_scene(torch, dev, g, levels)
        scenes[label] = (boxes, scores, valid, keep, thr)
        for dtype in (torch.float32, torch.bfloat16):
            sc = scores.to(dtype)
            for v in (valid, None):
                got = k5.box_nms_topk(boxes, sc, thr, v, keep)
                ref = k5.box_nms_topk_plain(boxes, sc, thr, v, keep)
                case = (f"{label}_{str(dtype)[6:]}_"
                        f"{'valid' if v is not None else 'no_valid'}")
                errs[case] = float((got != ref).sum())
                if got.dtype != torch.bool or errs[case]:
                    fail(f"K5 {case}: keep mask differs from the plain "
                         f"version at {int(errs[case])} candidates")
                if v is None:
                    continue
                picks = got.sum(1)
                if not (bool(got[0, 10]) and not bool(got[0, 11:14].any())
                        and bool(got[0, 20:24].all())
                        and bool(got[0, 40:42].all())
                        and int(picks[1]) == 0 and int(picks[2]) == 0
                        and 0 < int(picks[3]) <= 10
                        and int(picks[4:].min()) > 0):
                    fail(f"K5 {case}: planted cases wrong (picks per image "
                         f"{picks.tolist()})")
        extra[label] = {"candidates": int(boxes.shape[1]), "picks": keep,
                        "picks_longest_image": int(
                            k5.box_nms_topk(boxes, scores, thr, valid,
                                            keep).sum(1).max())}
    rounds = {t: argmax_round_ms(torch, dev, t) for t in (256, 1024)}
    for e in extra.values():
        e["latency_floor_ms"] = e["picks_longest_image"] * rounds[
            256 if e["candidates"] <= 256 else 1024]
    boxes, scores, valid, keep, thr = scenes["proposal"]
    M = boxes.shape[1]
    # boxes, scores and valid read once, the keep mask written
    n_bytes = B * M * (16 + 4 + 1 + 1)
    b, by = bound_ms(n_bytes)
    fns = {"": lambda: k5.box_nms_topk(boxes, scores, thr, valid, keep),
           "plain_": lambda: k5.box_nms_topk_plain(boxes, scores, thr, valid,
                                                   keep),
           "library_": None}
    for label in ("detection", "train"):
        fns[label + "_"] = (lambda b, s, v, k, t: lambda: k5.box_nms_topk(
            b, s, t, v, k))(*scenes[label])
    return dict(name="box_nms_topk", route="cuda",
                source="stlpose_tpu_torch/kernels/csrc/nms.cu",
                replaces="stlpose_tpu/ops/nms.py:194 (no Pallas original: "
                         "the fori_loop of _box_nms_topk)",
                max_abs_err=max(errs.values()), tolerance=0.0,
                case_errs=errs, bound_ms=b, bound_by=by, bytes=n_bytes,
                latency_floor_ms=extra["proposal"]["latency_floor_ms"],
                argmax_round_ms=rounds, shapes=extra,
                library="none (torchvision is not installed)",
                shape=[B, M, 4, keep],
                **event_times(torch, fns, cold=True)), fns


# ---------------------------------------------------------------- main path
def seeded_weights(torch, module, seed):
    """Random weights from ``seed``: fan-in scaled normal convolution and
    dense kernels, small biases, BatchNorm left at its identity
    statistics, so activations stay O(1) through both deep networks."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            elif name.endswith("bias") and ".bn." not in name \
                    and "_bn." not in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def seeded_bn_statistics(torch, module, seed):
    """Non-trivial BatchNorm from ``seed``: scale and running variance
    uniform in [0.5, 1.5], shift and running mean 0.1 x normal (so that
    folding them into the convolutions has work to do)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.weight, m.running_var):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return module


def reset_counts(mods):
    """Every launch counter to 0, each K3 instantiation's included."""
    for k in ("k1", "k2", "k3", "k3q", "k4", "k5"):
        mods[k].LAUNCHES = 0
    for by_type in (mods["k3"].LAUNCHES_BY_TYPE,
                    mods["k1"].LAUNCHES_BY_KERNEL):
        for v in by_type:
            by_type[v] = 0


def k1_took_bulk(mods, label):
    """The path's heatmaps reached K1 as contiguous NCHW maps: every K1
    launch since ``reset_counts`` took the bulk kernel."""
    by = dict(mods["k1"].LAUNCHES_BY_KERNEL)
    print(f"{label}: K1 launches by kernel:", json.dumps(by))
    if by["strided"] or not by["bulk"]:
        fail(f"{label}: K1 took the strided kernel ({by}); the path's "
             f"heatmaps are not contiguous NCHW maps")


def launch_counts(mods):
    """Launches since ``reset_counts``, by kernel record name."""
    counts = {"heatmap_peaks": mods["k1"].LAUNCHES,
              "affine_crop": mods["k2"].LAUNCHES,
              "quantize_levels": mods["k3q"].LAUNCHES,
              "warp_two_pass": mods["k4"].LAUNCHES,
              "box_nms_topk": mods["k5"].LAUNCHES}
    counts.update({ROI_RECORDS[v]: n
                   for v, n in mods["k3"].LAUNCHES_BY_TYPE.items()})
    return counts


@contextlib.contextmanager
def plain_versions(mods):
    """Route the six kernel entry points to their plain versions (the
    comparison runs only)."""
    entries = [(mods["k1"], "heatmap_peaks"), (mods["k2"], "affine_crop"),
               (mods["k3"], "roi_align"), (mods["k3q"], "quantize_levels"),
               (mods["k4"], "warp_two_pass"), (mods["k5"], "box_nms_topk")]
    saved = [getattr(m, name) for m, name in entries]
    for m, name in entries:
        setattr(m, name, getattr(m, name + "_plain"))
    try:
        yield
    finally:
        for (m, name), fn in zip(entries, saved):
            setattr(m, name, fn)


@contextlib.contextmanager
def recording(k1, log):
    """Append (heatmaps, (coords, maxvals, shift)) of every call of K1's
    entry point (kernel or plain version, whichever is in place) to
    ``log``."""
    fn = k1.heatmap_peaks

    def logged(hm):
        out = fn(hm)
        log.append((hm, out))
        return out

    k1.heatmap_peaks = logged
    try:
        yield
    finally:
        k1.heatmap_peaks = fn


def drive_fused(torch, mods, fused, images, required, label, iters):
    """Warm up, set every counter to 0, run one fused call and read the
    counters (each kernel in ``required`` must have launched); check
    shapes and finite keypoints; compare with the same program on the
    plain versions (``sel_valid``, ``picked_valid``, ``img_idx`` exact,
    keypoints and boxes to 1e-3 px, heatmap peaks to 1e-4); time it.
    Returns (launches, throughput, outputs, valid crops)."""
    fused(images)                                   # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    reset_counts(mods)
    out = fused(images)
    torch.cuda.synchronize()
    launches = launch_counts(mods)
    print(f"{label}: launches per fused call:", json.dumps(launches))
    if min(launches[k] for k in required) < 1:
        fail(f"a kernel of the {label} path was not launched: {launches}")
    if launches["box_nms_topk"] != 2:
        fail(f"{label}: K5 launched {launches['box_nms_topk']} times in one "
             f"detector_predict, not 2 (proposals, detections)")
    k1_took_bulk(mods, label)

    shapes = {"sel_boxes": (B, MAX_DETS, 4), "sel_scores": (B, MAX_DETS),
              "sel_valid": (B, MAX_DETS), "img_idx": (BUDGET,),
              "picked_valid": (BUDGET,), "crop_kpts": (BUDGET, 17, 3),
              "img_kpts": (BUDGET, 17, 3)}
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            fail(f"{label}: {k} has shape {tuple(out[k].shape)}, "
                 f"expected {s}")
    pv = out["picked_valid"]
    n_valid = int(pv.sum())
    if n_valid == 0:
        fail(f"{label}: no valid detection reached the pose stage")
    for k in ("sel_boxes", "crop_kpts", "img_kpts"):
        if not bool(torch.isfinite(out[k][pv if k != "sel_boxes"
                                          else out["sel_valid"]]).all()):
            fail(f"{label}: non-finite {k}")
    scores = out["sel_scores"][out["sel_valid"]]
    print(f"{label}: valid crops {n_valid}/{BUDGET}; person scores "
          f"{float(scores.min()):.4f}..{float(scores.max()):.4f}; "
          f"heatmap peaks {float(out['crop_kpts'][pv][..., 2].min()):.3f}.."
          f"{float(out['crop_kpts'][pv][..., 2].max()):.3f}")

    with plain_versions(mods):
        ref = fused(images)
    torch.cuda.synchronize()
    for k in ("sel_valid", "picked_valid", "img_idx"):
        if not torch.equal(out[k], ref[k]):
            fail(f"{label}: {k} differs between the kernels and the plain "
                 f"versions")
    both = pv & ref["picked_valid"]
    diffs = {k: float((out[k][both][..., :2] - ref[k][both][..., :2])
                      .abs().max()) for k in ("crop_kpts", "img_kpts")}
    diffs["maxvals"] = float((out["img_kpts"][both][..., 2] -
                              ref["img_kpts"][both][..., 2]).abs().max())
    diffs["sel_boxes"] = float((out["sel_boxes"] - ref["sel_boxes"])
                               .abs().max())
    print(f"{label}: kernels vs plain versions:", json.dumps(diffs))
    # keypoints to 1e-3 px, heatmap peaks to 1e-4, boxes to 1e-3 px
    if not (diffs["crop_kpts"] <= 1e-3 and diffs["img_kpts"] <= 1e-3 and
            diffs["maxvals"] <= 1e-4 and diffs["sel_boxes"] <= 1e-3):
        fail(f"{label} disagrees with its plain-version run: {diffs}")

    tput = throughput(torch, fused, images, n_valid, iters)
    tput["kernels_vs_plain"] = diffs
    print(f"{label}: end to end:", json.dumps(tput))
    return launches, tput, out, n_valid


def serving_images(torch, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 256, (B, 400, 400, 3), generator=g,
                         dtype=torch.uint8).to(dev)


def main_path(torch, mods, dev, args):
    """The f32 serving path: seeded weights, BatchNorm at identity."""
    t0 = time.time()
    det = seeded_weights(torch, mods["FasterRCNN"](mods["FasterRCNNConfig"](),
                                                   device=dev), args.seed)
    pose = seeded_weights(torch, mods["PoseHighResolutionNet"](
        mods["get_hrnet_config"]("w32_256x192"), device=dev), args.seed + 1)
    fused = mods["build_fused_two_stage"](det, pose, bbox_thr=BBOX_THR,
                                          max_dets=MAX_DETS, budget=BUDGET,
                                          device=dev)
    images = serving_images(torch, dev, args.seed + 2)
    print(f"models built in {time.time() - t0:.1f} s "
          f"(detector {sum(p.numel() for p in det.parameters())} params, "
          f"HRNet {sum(p.numel() for p in pose.parameters())})", flush=True)
    launches, tput, _, n_valid = drive_fused(
        torch, mods, fused, images,
        ("heatmap_peaks", "affine_crop", "roi_align"), "f32 serving",
        args.iters)
    return launches, tput, (det, pose, fused, images, n_valid)


def rel_err(torch, got, ref):
    """max |got - ref| over max |ref|, in f32."""
    return float((got.float() - ref.float()).abs().max() /
                 ref.float().abs().max())


def quant_path(torch, mods, dev, args):
    """The quantized bf16 serving flavor at full width: seeded weights
    with seeded non-trivial BatchNorm, folded by the port's own
    ``apply_trunk_flavor`` / ``fold_batchnorms``, into a bf16 detector
    with the int8 RoI patch pyramid and a bf16 HRNet. Checks the folded
    f32 models against the unfolded ones (FPN maps and heatmaps within
    5e-5 of their largest magnitude: two f32 programs whose weights round
    differently, through cuDNN's FFT and GEMM algorithms; H100 readings
    4.4e-6 and 3.7e-6), then drives the
    fused call (K1, K2, K3q and K3's int8 -> bf16 instantiation launched, the
    plain-version run agreeing), and records the drift of its outputs from
    the f32 flavor on the same weights (not a gate)."""
    t0 = time.time()
    FRCNN, HRNet = mods["FasterRCNN"], mods["PoseHighResolutionNet"]
    cfg, hcfg = mods["FasterRCNNConfig"](), mods["get_hrnet_config"](
        "w32_256x192")
    det = seeded_bn_statistics(torch, seeded_weights(
        torch, FRCNN(cfg, device=dev), args.seed + 6), args.seed + 7)
    pose = seeded_bn_statistics(torch, seeded_weights(
        torch, HRNet(hcfg, device=dev), args.seed + 8), args.seed + 9)
    det_sd = mods["apply_trunk_flavor"](det.state_dict(), "folded")
    pose_sd = mods["fold_batchnorms"](pose.state_dict())

    def flavor(cls, config, sd, **kw):
        m = cls(config, device=dev, **kw)
        m.load_state_dict(sd)
        return m

    images = serving_images(torch, dev, args.seed + 2)
    g = torch.Generator(device=dev).manual_seed(args.seed + 10)
    crops = torch.randn((16, 256, 192, 3), generator=g, device=dev)
    with torch.inference_mode():
        x = (images.float() / 255.0).permute(0, 3, 1, 2).contiguous()
        det_f = flavor(FRCNN, cfg, det_sd, trunk_quant="folded")
        fold = {"detector_fpn": max(rel_err(torch, a, b) for a, b in zip(
            det_f.features(x), det.features(x)))}
        del det_f
        pose_f = flavor(HRNet, hcfg, pose_sd, folded=True)
        fold["hrnet"] = rel_err(torch, pose_f(crops), pose(crops))
        del pose_f
    print("folded f32 vs unfolded f32 (max abs diff / max abs):",
          json.dumps(fold), flush=True)
    if not max(fold.values()) <= 5e-5:
        fail(f"folded f32 models disagree with the unfolded ones: {fold}")

    det_q = flavor(FRCNN, cfg, det_sd, dtype=torch.bfloat16,
                   roi_patch_quant=True, trunk_quant="folded")
    pose_q = flavor(HRNet, hcfg, pose_sd, dtype=torch.bfloat16, folded=True)
    fused = mods["build_fused_two_stage"](det_q, pose_q, bbox_thr=BBOX_THR,
                                          max_dets=MAX_DETS, budget=BUDGET,
                                          device=dev)
    print(f"quantized bf16 models built in {time.time() - t0:.1f} s",
          flush=True)
    launches, tput, out, n_valid = drive_fused(
        torch, mods, fused, images,
        ("heatmap_peaks", "affine_crop", "quantize_levels",
         "roi_align_i8_bf16"), "quantized bf16 serving", args.iters)

    # the f32 flavor on the same weights: a record, not a gate
    ref = mods["build_fused_two_stage"](det, pose, bbox_thr=BBOX_THR,
                                        max_dets=MAX_DETS, budget=BUDGET,
                                        device=dev)(images)
    sv = out["sel_valid"] & ref["sel_valid"]
    same = out["picked_valid"] & ref["picked_valid"] & \
        (out["img_idx"] == ref["img_idx"])
    kd = (out["img_kpts"][same][..., :2] - ref["img_kpts"][same][..., :2]) \
        .abs()

    def largest(t):
        return float(t.max()) if t.numel() else None
    drift = {"sel_valid_equal": bool(torch.equal(out["sel_valid"],
                                                 ref["sel_valid"])),
             "img_idx_equal": bool(torch.equal(out["img_idx"],
                                               ref["img_idx"])),
             "sel_boxes_max_abs_px": largest((out["sel_boxes"][sv] -
                                              ref["sel_boxes"][sv]).abs()),
             "sel_scores_max_abs": largest((out["sel_scores"][sv].float() -
                                            ref["sel_scores"][sv]).abs()),
             "img_kpts_max_abs_px": largest(kd),
             "img_kpts_median_abs_px": float(kd.median()) if kd.numel()
             else None}
    print("quantized bf16 vs f32 flavor, same weights (record):",
          json.dumps(drift), flush=True)
    tput["drift_from_f32"] = drift
    tput["fold_rel_err"] = fold
    return launches, tput, (fused, images, n_valid)


def throughput(torch, fused, images, n_valid, iters):
    """images/s and crops/s of the fused call on the host clock, over
    ``iters`` calls after two warm-up calls, each end synchronised."""
    for _ in range(2):
        fused(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fused(images)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"images_per_s": B * iters / dt, "crops_per_s": n_valid * iters / dt,
            "ms_per_call": dt / iters * 1e3, "iters": iters}


def train_path(torch, mods, dev, args):
    """Pose training at full width: seeded HRNet-W32, Adam, batches from
    the device-warp collate (host samples made first, as the decode
    threads would), 2 warm-up iterations, then TRAIN_STEPS timed ones,
    one eval step and one scheduler step with every launch counter set to
    0 first; K1 against its plain version on the last timed step's own
    heatmaps; then one step on the kernels against the same step on the
    plain versions."""
    import copy
    k1 = mods["k1"]
    t0 = time.time()
    images, recs = synthetic_records(mods, args.seed + 4)
    pipe = mods["PoseDataPipeline"](recs, TRAIN_B, is_train=True,
                                    exp_data=AUG, seed=args.seed,
                                    canvas_size=CANVAS, device=dev)
    raw = [[pipe._letterbox(img, r) for img, r in zip(images, recs)]
           for _ in range(4)]
    eval_pipe = mods["PoseDataPipeline"](recs, TRAIN_B, is_train=False,
                                         canvas_size=CANVAS, device=dev)
    eval_raw = [eval_pipe._letterbox(img, r) for img, r in zip(images, recs)]
    model = seeded_weights(torch, mods["PoseHighResolutionNet"](
        mods["get_hrnet_config"]("w32_256x192"), device=dev), args.seed + 3)
    state = mods["create_train_state"](model, EXP)
    train_step = mods["make_train_step"](perceptual_cfg=EXP)
    eval_step = mods["make_eval_step"]()
    print(f"training set-up in {time.time() - t0:.1f} s", flush=True)

    def iteration(samples):
        batch = pipe._collate_device_warp(samples, recs)
        return batch, train_step(state, batch)

    for i in range(2):                              # warm-up (cuDNN plans)
        iteration(raw[i])
    torch.cuda.synchronize()
    watch = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k in ("stem1.conv.weight", "final_layer.weight",
                      "stem1.bn.running_mean", "stem1.bn.running_var",
                      "stage4_m2.branch3_block3.cb2.bn.running_var")}
    acc = mods["MetricAccumulator"](finite_only=("loss",))
    reset_counts(mods)
    fin_ms = step_ms = 0.0
    seen = []                       # K1's calls in the last timed step
    for i in range(TRAIN_STEPS):
        t_a = time.perf_counter()
        batch = pipe._collate_device_warp(raw[i % len(raw)], recs)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        with (recording(k1, seen) if i == TRAIN_STEPS - 1
              else contextlib.nullcontext()):
            acc.update(train_step(state, batch))
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        fin_ms += (t_b - t_a) * 1e3
        step_ms += (t_c - t_b) * 1e3
    train_m = acc.fetch()
    eval_acc = mods["MetricAccumulator"]()
    pred, em = eval_step(state, eval_pipe._collate_device_warp(eval_raw,
                                                               recs))
    eval_acc.update(em)
    eval_m = eval_acc.fetch()
    sched = mods["build_scheduler"](EXP)
    lr = sched.step(eval_m["loss_mean"], mods["get_current_lr"](
        state.optimizer))
    mods["set_current_lr"](state.optimizer, lr)
    torch.cuda.synchronize()
    launches = launch_counts(mods)
    print("training-path launches:", json.dumps(launches))
    if launches["warp_two_pass"] < 1 or launches["heatmap_peaks"] < 1:
        fail(f"a kernel of the training path was not launched: {launches}")
    k1_took_bulk(mods, "training")
    if train_m["loss_n"] != TRAIN_STEPS or \
            not np.isfinite(train_m["loss_mean"]):
        fail(f"non-finite training loss: {train_m}")
    if tuple(pred.shape) != (TRAIN_B, 17, 64, 48) or \
            not bool(torch.isfinite(pred).all()):
        fail("eval step: bad heatmaps")
    now = model.state_dict()
    unmoved = [k for k, v in watch.items() if torch.equal(v, now[k])]
    if unmoved:
        fail(f"training left these unchanged: {unmoved}")

    # K1 on the last timed step's own heatmaps (train-mode predictions,
    # then Gaussian targets: all-zero maps for invisible joints, exact
    # ties): exact agreement with its plain version
    if [tuple(hm.shape) for hm, _ in seen] != [(TRAIN_B, 17, 64, 48)] * 2:
        fail(f"K1 calls of a train step: {[hm.shape for hm, _ in seen]}")
    k1_train = {}
    for label, (hm, out) in zip(("pred", "target"), seen):
        ref = k1.heatmap_peaks_plain(hm)
        if not all(torch.equal(g, r) for g, r in zip(out, ref)):
            errs = [float((g - r).abs().max()) for g, r in zip(out, ref)]
            fail(f"K1 differs from its plain version on the step's {label} "
                 f"heatmaps by {errs}")
        k1_train[f"{label}_maps_all_zero"] = int(
            (hm.amax(dim=(2, 3)) == 0).sum())
    print("K1 on the training step's heatmaps: equal to its plain version",
          json.dumps(k1_train))

    # one step on the kernels, the same step on the plain versions
    torch.backends.cudnn.deterministic = True
    saved = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()))
    try:
        outs = []
        for plain in (False, True):
            # load_state_dict keeps the optimizer's tensors, which the step
            # then updates in place: hand it a fresh copy each time
            model.load_state_dict(saved[0])
            state.optimizer.load_state_dict(copy.deepcopy(saved[1]))
            peaks = []
            with (plain_versions(mods) if plain
                  else contextlib.nullcontext()), recording(k1, peaks):
                _, m = iteration(raw[0])
            outs.append((float(m["loss"]), int(m["pck_hit"]),
                         int(m["pck_cnt"]), [o[0] for _, o in peaks],
                         [p.detach().clone() for p in model.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, hk, ck, ak, pk), (lp, hp, cp, ap, pp) = outs
    param_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(pk, pp))
    # the peaks of the predictions and of the targets: equal coordinates
    peaks_equal = len(ak) == len(ap) == 2 and all(
        torch.equal(a, b) for a, b in zip(ak, ap))
    vs_plain = {"loss_kernels": lk, "loss_plain": lp,
                "loss_rel_diff": abs(lk - lp) / abs(lp),
                "pck_hit_kernels": hk, "pck_hit_plain": hp,
                "pck_cnt_kernels": ck, "pck_cnt_plain": cp,
                "argmax_coords_equal": peaks_equal,
                "param_max_rel_diff": param_err}
    print("training step, kernels vs plain versions:", json.dumps(vs_plain))
    if not (vs_plain["loss_rel_diff"] <= 1e-6 and hk == hp and ck == cp
            and peaks_equal and param_err <= 1e-6):
        fail(f"training step disagrees with its plain-version run: "
             f"{vs_plain}")

    n = TRAIN_STEPS
    summary = {"batch": TRAIN_B, "steps": n,
               "ms_per_step": (fin_ms + step_ms) / n,
               "finalize_ms": fin_ms / n, "train_step_ms": step_ms / n,
               "samples_per_s": TRAIN_B * n / (fin_ms + step_ms) * 1e3,
               "loss_mean": train_m["loss_mean"],
               "pck": train_m["pck_hit_sum"] / max(train_m["pck_cnt_sum"], 1),
               "eval_loss": eval_m["loss_mean"], "lr_after_scheduler": lr,
               "kernels_vs_plain": vs_plain}
    print("training:", json.dumps(summary), flush=True)
    return launches, summary, (iteration, raw[0])


def forbidden_ops(prof, ops, shapes):
    """[(op, input shapes)] of the profiled ops named in ``ops`` that took
    an input of one of ``shapes`` (the profile must record shapes)."""
    return [(e.key, e.input_shapes)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in ops and any(list(sh) in shapes
                                    for sh in e.input_shapes)]


def profile_program(torch, fn, ms_per_call, out_dir, label, expect=(),
                    forbid=None):
    """One call of ``fn`` (after one outside it) under torch.profiler:
    kernel launches, device busy time, idle share against the unprofiled
    ``ms_per_call``, the device ms of the kernels whose names hold one of
    ``expect`` (each must appear in a trace that has device rows), and the
    kernels that take the time (appended to DIR/chip_smoke_profile.txt).
    ``forbid``: (op names, input shapes) that must not meet in the call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=forbid is not None) as prof:
        fn()
        torch.cuda.synchronize()
    if forbid is not None:
        hits = forbidden_ops(prof, *forbid)
        if hits:
            fail(f"{label}: ops that must not run in it ran: {hits}")
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    summary = {"device_busy_ms": busy, "idle_share": 1.0 - busy / ms_per_call,
               "kernel_launches": sum(r[1] for r in rows)}
    if expect and rows:
        named = {e: sum(t for t, _, k in rows if e in k) for e in expect}
        if not all(named.values()):
            fail(f"{label}: no device row of {named} in its profile")
        summary["named_kernels_ms"] = named
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "a") as f:
            f.write(f"{label} " + json.dumps(summary) + "\n")
            for t, c, k in rows[:40]:
                f.write(f"{t:10.3f} ms {c:6d}x  {k}\n")
    print(f"profile of {label}:", json.dumps(summary))
    for t, c, k in rows[:8]:
        print(f"  {t:9.3f} ms {c:6d}x  {k[:90]}")
    return summary


def nms_inputs(torch, dev):
    """Random boxes at the main path's two NMS shapes: proposals (B, 2147
    candidates, 256 picks) and detections (B, 256 candidates, 64 picks)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    for label, M, keep in (("proposal_nms", 2147, 256),
                           ("detection_nms", 256, 64)):
        xy = torch.rand((B, M, 2), generator=g) * 380
        bx = torch.cat([xy, xy + torch.rand((B, M, 2), generator=g) * 60], -1)
        yield label, bx.to(dev), torch.rand((B, M), generator=g).to(dev), keep


def stage_times(torch, mods, state):
    """CUDA-event ms per call of the path's stages alone, at its shapes:
    the detector, its backbone + FPN, HRNet-W32 on the crop budget, the
    two NMS calls (K5); the detector with K5's plain loop in place of the
    kernel; the fused call and the detector with NMS stubbed out (every
    valid candidate kept: what NMS costs in place); HRNet with cuDNN's
    autotuner on. Taken before any profiler session."""
    det, pose, fused, images, _ = state
    nms = mods["box_nms_topk"]
    images01 = images.to(torch.float32) / 255.0
    crops = torch.rand((BUDGET, 256, 192, 3), device=images.device)
    with torch.inference_mode():
        stages = {
            "detector_predict": elapsed_ms(
                torch, lambda: det.predict(images01), 3),
            "detector_backbone_fpn": elapsed_ms(
                torch, lambda: det.features(
                    images01.permute(0, 3, 1, 2).contiguous()), 3),
            "hrnet_w32": elapsed_ms(torch, lambda: pose(crops), 3)}
        for label, bx, sc, keep in nms_inputs(torch, images.device):
            stages[label] = elapsed_ms(
                torch, lambda: nms(bx, sc, 0.5, None, keep), 3)
        k5 = mods["k5"]
        kernel = k5.box_nms_topk
        k5.box_nms_topk = k5.box_nms_topk_plain
        try:
            stages["detector_predict_nms_plain"] = elapsed_ms(
                torch, lambda: det.predict(images01), 3)
        finally:
            k5.box_nms_topk = kernel
        frcnn = sys.modules[type(det).__module__]
        frcnn.box_nms_topk = lambda b, s, t, valid, k: valid & (s > -1e30)
        try:
            stages["detector_predict_nms_stubbed"] = elapsed_ms(
                torch, lambda: det.predict(images01), 3)
            stages["fused_call_nms_stubbed"] = elapsed_ms(
                torch, lambda: fused(images), 3)
        finally:
            frcnn.box_nms_topk = nms
        torch.backends.cudnn.benchmark = True
        try:
            stages["hrnet_w32_cudnn_benchmark"] = elapsed_ms(
                torch, lambda: pose(crops), 3)
        finally:
            torch.backends.cudnn.benchmark = False
    print("stages alone (ms per call):", json.dumps(stages))
    return stages


def profile_main_path(torch, mods, state, ms_per_call, out_dir):
    """One fused call under torch.profiler: kernel launches (fewer than
    MAX_FUSED_LAUNCHES), device busy time and idle share (against the
    unprofiled ``ms_per_call``), the kernels that take the time; the NMS
    calls' launch counts; and the throughput once more, now that the
    profiler has run."""
    from torch.profiler import ProfilerActivity, profile
    _, _, fused, images, n_valid = state
    fused(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fused(images)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)

    nms = mods["box_nms_topk"]
    nms_counts = {}
    for label, bx, sc, keep in nms_inputs(torch, images.device):
        n, ms = device_profile(torch, lambda: nms(bx, sc, 0.5, None, keep))
        nms_counts[label] = {"kernel_launches": n, "device_ms": ms}
    after = throughput(torch, fused, images, n_valid, 3)
    summary = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
               "idle_share": 1.0 - busy / ms_per_call,
               "kernel_launches": n_kernels, "nms": nms_counts,
               "ms_per_call_after_profiling": after["ms_per_call"]}
    if rows and n_kernels >= MAX_FUSED_LAUNCHES:
        fail(f"one f32 fused call launched {n_kernels} kernels (limit "
             f"{MAX_FUSED_LAUNCHES}): has the per-pick NMS chain returned?")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
            f.write(json.dumps(summary) + "\n")
            for t, c, k in rows[:40]:
                f.write(f"{t:10.3f} ms {c:6d}x  {k}\n")
    print("profile of one fused call:", json.dumps(summary))
    for t, c, k in rows[:8]:
        print(f"  {t:9.3f} ms {c:6d}x  {k[:90]}")
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="directory for the profile's 40 largest kernels")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from stlpose_tpu_torch.config import FasterRCNNConfig, get_hrnet_config
    from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
    from stlpose_tpu_torch.data.pose_dataset import (AugmentationParams,
                                                     PoseRecord, _xywh_to_cs)
    from stlpose_tpu_torch.engines.vase_evaluator import build_fused_two_stage
    from stlpose_tpu_torch.kernels import _build
    from stlpose_tpu_torch.kernels import decode as k1
    from stlpose_tpu_torch.kernels import nms as k5
    from stlpose_tpu_torch.kernels import quantize as k3q
    from stlpose_tpu_torch.kernels import roi_align as k3
    from stlpose_tpu_torch.kernels import warp as k2
    from stlpose_tpu_torch.kernels import warp_two_pass as k4
    from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
    from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
    from stlpose_tpu_torch.models.quantize import (apply_trunk_flavor,
                                                   fold_batchnorms)
    from stlpose_tpu_torch.ops import affine
    from stlpose_tpu_torch.ops import roi_align as roi_ops
    from stlpose_tpu_torch.ops.nms import box_nms_topk
    from stlpose_tpu_torch.ops.warp import affine_warp, two_pass_params
    from stlpose_tpu_torch.parallel.steps import (MetricAccumulator,
                                                  make_eval_step,
                                                  make_train_step)
    from stlpose_tpu_torch.train.optim import (build_scheduler,
                                               get_current_lr,
                                               set_current_lr)
    from stlpose_tpu_torch.train.state import create_train_state

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    logs = _build.build(["decode", "warp", "roi_align", "quantize",
                         "warp_two_pass", "nms"])
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    mods = dict(k1=k1, k2=k2, k3=k3, k3q=k3q, k4=k4, k5=k5,
                FasterRCNN=FasterRCNN,
                FasterRCNNConfig=FasterRCNNConfig,
                PoseHighResolutionNet=PoseHighResolutionNet,
                get_hrnet_config=get_hrnet_config,
                build_fused_two_stage=build_fused_two_stage,
                box_nms_topk=box_nms_topk, PoseRecord=PoseRecord,
                xywh_to_cs=_xywh_to_cs, AugmentationParams=AugmentationParams,
                two_pass_params=two_pass_params, affine_warp=affine_warp,
                PoseDataPipeline=PoseDataPipeline,
                create_train_state=create_train_state,
                make_train_step=make_train_step,
                make_eval_step=make_eval_step,
                MetricAccumulator=MetricAccumulator,
                build_scheduler=build_scheduler,
                get_current_lr=get_current_lr, set_current_lr=set_current_lr,
                apply_trunk_flavor=apply_trunk_flavor,
                fold_batchnorms=fold_batchnorms)
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    checks = [check_decode(torch, k1, dev, rng),
              check_warp(torch, k2, affine, affine_warp, dev, rng)]
    scene = roi_scene(torch, roi_ops, dev, rng)
    odd = odd_roi_scene(torch, roi_ops, dev, rng)
    checks.append(check_quantize(torch, k3q, scene, odd))
    checks += [check_roi_variant(torch, k3, k3q, roi_ops, scene, odd,
                                 variant)
               for variant in ROI_RECORDS]
    checks.append(check_warp_two_pass(torch, k4, mods, dev, args.seed + 5))
    checks.append(check_nms(torch, k5, dev, args.seed + 11))
    for k, _ in checks:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']} (tol "
              f"{k['tolerance']})", flush=True)

    launches, tput, state = main_path(torch, mods, dev, args)
    stages = stage_times(torch, mods, state)
    q_launches, quant, q_state = quant_path(torch, mods, dev, args)
    train_launches, train, train_state = train_path(torch, mods, dev, args)

    # torch.profiler from here on: every host-clock and CUDA-event time
    # above was taken before its first session
    kernels = []
    for k, fns in checks:
        device_times(torch, k, fns)
        by_path = {"serving": launches[k["name"]],
                   "serving_bf16_roi8": q_launches[k["name"]],
                   "training": train_launches[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        kernels.append(k)
        print(f"{k['name']}: kernel {k['ms']} ms, plain {k['plain_ms']} ms, "
              f"library {k['library_ms']} ms, bound {k['bound_ms']} ms "
              f"({k['bound_by']}), launches on the main path "
              f"{k['launches']}", flush=True)
        if "cold_ms" in k:
            print(f"  {k['name']} cold L2: kernel {k['cold_ms']} ms, "
                  f"library {k.get('library_cold_ms')} ms", flush=True)
    prof = profile_main_path(torch, mods, state, tput["ms_per_call"],
                             args.out)
    q_fused, q_images, _ = q_state
    quant["profile"] = profile_program(
        torch, lambda: q_fused(q_images), quant["ms_per_call"], args.out,
        "one quantized bf16 fused call",
        expect=("absmax_kernel", "quantize_kernel", "roi_align_kernel"),
        forbid=(QUANTIZE_OPS, [[B, s, s, ROI_C] for s in ROI_SIZES]))
    iteration, samples = train_state
    train["profile"] = profile_program(
        torch, lambda: iteration(samples), train["ms_per_step"], args.out,
        "one training iteration")

    print(card)
    print(json.dumps({"kernels": kernels, "end_to_end": tput,
                      "stages_ms": stages, "profile": prof,
                      "serving_bf16_roi8": quant, "training": train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
