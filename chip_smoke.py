#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stlpose_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--iters 5] [--out DIR]

Phases, each fatal on failure:
  1. print the card (nvidia-smi name, power limit); TF32 off;
  2. build the seven CUDA kernel sources from
     stlpose_tpu_torch/kernels/csrc (one nvcc per source, in parallel) and
     print the build time;
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
     f32 and bf16 scores, with and without a valid mask, and on the
     edges of its sorted-bitmask design (``nms_edge_cases``: M = 37 and
     M = 130, max_keep above the alive count, NaN scores and boxes,
     M = 20,000 and M = 40,000, whose sort runs in global memory); the
     pick-argmax latency floor from an empty block-wide argmax round,
     and the design's own floor (``nms_design_floor``); K3b (RoIAlign's
     gradient for the maps) within 1e-5 of the plain maps' max abs at the
     training shape (B = 8, 256 boxes, C = 256, ``roi_scene``), on a
     planted scene (``roi_backward_scene``: every level, past every
     border, under one pixel, tall, wide) and at C = 36, each run twice
     and the two runs equal bit for bit;
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
  4c. the qualitative vase engine behind 04_evaluate_vases_qualitatively.py
     (VaseEvaluator) at the same width: phase 4's seeded models saved as
     a temporary experiment's pose and detector checkpoints "final" and
     loaded through the engine's loaders, the vase pipeline's images made
     in memory (seeded sources of 240-640 px letterboxed to 400x400, no
     cv2 on the card's machine), no drawing; counters set to 0, 04's
     traffic (qualitative_comparison over 11 records at B = 1), one batch
     of 8 canvases (7 images, one empty) and 13 records at B = 8 (a short
     tail batch): K1 (bulk), K2, K3 f32 and K5 (twice a fused call)
     launched; at a bbox_thr that makes the per-image counts vary, the
     fused engine against its host path (boxes 1e-4, scores 1e-5,
     keypoints 1e-3) and against itself on the plain versions; the
     quantized bf16 flavor (K3q and K3 int8 -> bf16 launched, kernels vs
     plain, tied scores counted); the torchvision-parity detector (K5 on
     3,654 proposal candidates and K3 on
     8 x 1000 boxes, each against its plain version on the call's
     inputs); engine ms per image at B = 1, per batch at B = 8 in turns
     with phase 4's bare fused call and split into upload, fused program
     and fetch + unpack; host-path, bf16 and torchvision-parity ms;
  5. drive the pose training path at full width (HRNet-W32 256x192, f32,
     B = 32, Adam lr 1e-3, seeded weights): batches from the device-warp
     collate on seeded 640x640 uint8 canvases with the COCO augmentation
     recipe, train steps, one eval step and one scheduler step, counters
     set to 0 first; check a finite loss, moved parameters and BatchNorm
     statistics, K4 and K1 launched, K1 against its plain version on the
     last timed step's own prediction and target heatmaps, and one step
     on the kernels against the same step on the plain versions (cuDNN
     deterministic: loss, PCK hits and count, every peak, parameters);
     time samples/s and ms per step, split into finalize and step, and
     the step with and without model.train() before it (the train-mode
     guard), in turns;
  5b. flip-TTA COCO evaluation through the port's PoseEvaluator at full
     width (HRNet-W32 256x192, f32, B = 64, so 128 crops a forward):
     256 seeded 640x640 images with two people each written as a
     COCO-layout annotation file, the seeded weights saved as the
     experiment's "final" checkpoint, the valid pipeline reading the
     decoded canvases from memory (no cv2 on the card's machine); counters
     set to 0 first, one evaluate_model (K4 and K1 launched, K1 through
     its bulk kernel; 10 finite stats in the JSON keyed by checkpoint),
     a second timed (ms per batch, crops/s, host seconds of the
     submission and of COCO scoring); one batch split into collate,
     fused eval-decode step (CUDA events) and host consume; the step
     without flip, and with the flip combine in the (N, J, H, W) layout;
     the step on the
     kernels against the same step on the plain versions (keypoints 1e-3
     px, maxima 1e-4, loss and PCK exact, K1 on its own heatmaps exact);
     the oracle AP/AR (target heatmaps decoded and scored, >= 0.95); the
     bf16 flavor's ms per batch and its drift from f32 (a record);
  5c. the training CLI (01 -> 02 -> 03) in-process through the scripts'
     main(argv) and PoseTrainer at full width (HRNet-W32 256x192, B = 32,
     Styled-COCO with perceptual-loss weighting and the COCO augmentation,
     device warp): 128 train and 80 valid seeded 640x640 images with two
     people each (8 train batches an epoch, 1 validation batch), read
     from memory; seeded weights saved as the experiment's checkpoint
     "seed" and loaded weights-only; counters set to 0, two f32 epochs
     (K4 and K1 launched, K1 through its bulk kernel; 2 finite epochs in
     training_logs.json, checkpoints 0, 1 and final, the StepTimer stats,
     the scheduler stepped); a resume from checkpoint 1 (epoch, step,
     learning rate and scheduler restored); the trainer on the kernels
     against the trainer on the plain versions (first train batch's crops
     and targets 0.0, its step within the training path's limits, first
     valid batch's loss and PCK equal); one bf16 epoch (parameters, Adam
     moments and checkpoint f32); 03 on "final" with flip-TTA (10 finite
     stats); the engine's ms per iteration against the training path's
     bare loop, the validation epoch's ms, the bf16 ms per iteration;
  5d. style transfer (the VGG16 perceptual loss, the AdaIN stylizer inline
     in both pipelines and the three aux scripts' stages), seeded
     weights, f32: the stylizer at B = 32 on 256x192 crops from a bank of
     16 seeded exemplars (alpha 0.8 and a per-sample alpha vector) and on
     the preload's 512x512 canvases (finite, in [0, 1], alpha 0 apart
     from alpha 1, a second call equal, the same weights on the CPU at
     B = 2 within STYLE_CPU_TOL); the perceptual loss (VGG16 to relu4_3)
     at B = 64 on 224x224 (identical inputs 0, a small corruption below a
     large one, the CPU within LOSS_CPU_REL_TOL); train_adain_decoder at
     B = 8 on 256x256 (recon_weight 1, 10 steps, the loss falls); the
     detection pipeline's stylizer through get_detection_dataset at
     400x400, B = 8 (canvases changed; boxes, labels and masks equal the
     unstylized batch's); then the style CLI in-process: 01 with
     --inline_style_dir and --inline_style_alpha 0.8 -> 02 (HRNet-W32,
     B = 32, Styled-COCO with perceptual weighting, host warp, the crops
     and exemplars from memory, one epoch of 4 batches; counters set to 0
     first: K1 launched, K4 not; the train pipeline stylized, validation
     not) -> 03 on "final" (10 finite stats); the stylizer's ms per batch
     beside the collate's and the step's;
  5e. detector training at full width (FasterRCNNConfig(): ResNet-50-FPN,
     C = 256, 400x400, train budgets pre 1000 / post 512, 256 RPN anchors
     and 256 RoIs an image; B = 8, f32, Adam, seeded weights and
     BatchNorm; 32 train and 16 valid seeded canvases with 1-4 people
     each, read from memory through the detection pipeline): K5 at the
     torchvision-parity budget (M = 6,529, 2000 picks) exactly against
     its plain loop; counters set to 0, one
     train step (finite loss terms, every parameter and running statistic
     moved, stem_bn's included; K3 f32, K3b and K5 launched); the loss
     and its gradient on the kernels against the plain versions (cuDNN
     deterministic; terms 1e-5 relative, every gradient 1e-4 of its max
     abs), and on the kernels twice (the gradients' run-to-run
     difference; where it is not 0.0, the first op of the step whose
     output differs between two runs on equal inputs is named); K3b on
     the inputs it got in the measured step (``roi_backward_on_step``:
     the sampled RoIs, clustered around the people), against its plain
     version and itself, timed warm and cold; ms per
     step and samples/s, split into forward + loss and backward + update;
     one step of the torchvision-parity detector (K5 at M = 6,529); then
     the detector CLI in-process:
     01 -> 02_train_faster_rcnn (2 epochs: 2 finite losses and 2 APs in
     detector_logs.json, checkpoints 0, 1 and final, the plateau
     scheduler stepped on AP) -> a resume from checkpoint 1 ->
     03_evaluate_faster_rcnn on "final" (12 stats, finite or -1), with ms
     per train and per validation epoch;
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
     kernels into DIR/chip_smoke_profile.txt when --out is given), also
     with model.train() before the step (as every step ran before the
     train-mode guard); one eval-decode step's launches and idle share
     likewise, in each layout of the flip combine; one engine training
     iteration (PoseTrainer's loop body: pipeline, step, metric update)
     likewise, in f32 and in bf16; one vase engine call at B = 1 and one
     at B = 8 likewise; one stylizer call at B = 32 on 256x192 crops and
     one style engine iteration (host warp, crops stylized) likewise; one
     detector train step likewise (K3, K3b and K5 in its trace).
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
import tempfile
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
# (stlpose_tpu/models/faster_rcnn.py:58-60, pre_nms_top_n_train 1000 of
# P2-P4's anchors, all 507 and 147 of P5 and P6: 3,654 candidates)
NMS_SHAPES = (("proposal", (500, 500, 500, 500, 147), 256, 0.7),
              ("detection", (256,), 64, 0.5),
              ("train", (1000, 1000, 1000, 507, 147), 512, 0.7))


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


def nms_edge_cases(torch, dev, g):
    """(label, boxes, scores, valid, max_keep, threshold) at the edges of
    K5's sorted-bitmask design: M = 37 (one partial chunk of 64) and
    M = 130 (a partial third chunk); max_keep above the alive count (130
    candidates, a third of them invalid, 200 picks: the scan runs out of
    candidates first); NaN scores (dead) and NaN box coordinates (IoU NaN:
    neither suppressing nor suppressed) among 300 candidates; M = 20,000
    (the block radix sort at 32 keys a thread) and M = 40,000 (above
    32,768: the bitonic sort in the workspace), B = 2."""
    def scene(n_img, M, extent=200.0, size=60.0):
        xy = torch.rand((n_img, M, 2), generator=g) * extent
        wh = torch.rand((n_img, M, 2), generator=g) * size
        return (torch.cat([xy, xy + wh], -1),
                torch.randn((n_img, M), generator=g))

    cases = []
    for M, keep in ((37, 16), (130, 40)):
        boxes, scores = scene(B, M)
        cases.append((f"m{M}", boxes, scores, None, keep, 0.5))
    boxes, scores = scene(B, 130)
    valid = torch.rand((B, 130), generator=g) > 0.33
    cases.append(("keep_above_alive", boxes, scores, valid, 200, 0.5))
    boxes, scores = scene(B, 300)
    boxes[:, 3::11, 0] = torch.nan
    boxes[:, 5::13, 3] = torch.nan
    scores[:, 3::11] = 9.0                      # NaN boxes picked first
    scores[:, ::7] = torch.nan
    cases.append(("nan_scores_boxes", boxes, scores, None, 64, 0.5))
    for M in (20000, 40000):
        boxes, scores = scene(2, M, extent=2000.0)
        cases.append((f"m{M}", boxes, scores, None, 300, 0.7))
    return [(label, b.to(dev), s.to(dev), None if v is None else v.to(dev),
             keep, thr) for label, b, s, v, keep, thr in cases]


def nms_design_floor(torch, boxes, scores, valid, keep_mask, max_keep,
                     rounds):
    """The least time of K5's sorted-bitmask design on these inputs, what
    its three kernels serialize: the block radix sort's 8 passes (4 bits
    of the 32-bit keys each), each at least one block-wide round (256
    threads up to 4,096 candidates, else 1024); two rounds of 256
    threads (the resolve, then the reduction of the removed word) per
    64-candidate chunk that the longest image's scan visits (to its
    max_keep-th keep, else to its last alive candidate); and the
    bitmask's words (the upper triangle of the alive candidates' 64 x 64
    blocks) written once at 3.35 TB/s. ``rounds``: threads -> ms of one
    empty block-wide argmax round. Returns (ms, chunks visited)."""
    Bn, M = scores.shape
    alive = scores.float() > -torch.inf
    if valid is not None:
        alive &= valid
    key = torch.where(alive, scores.float() + 0.0, -torch.inf)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    kept_sorted = torch.gather(keep_mask, 1, order).int()
    n_alive = alive.sum(1)
    chunks = 0
    for b in range(Bn):
        kept = kept_sorted[b].cumsum(0)
        if int(kept[-1]) >= max_keep > 0:
            last = int((kept >= max_keep).nonzero()[0, 0])
        else:
            last = int(n_alive[b]) - 1
        chunks = max(chunks, last // 64 + 1 if last >= 0 else 0)
    words = sum(((int(n) + 63) // 64) * ((int(n) + 63) // 64 + 1) // 2 * 64
                for n in n_alive)
    return (8 * rounds[256 if M <= 4096 else 1024] +
            2 * chunks * rounds[256] +
            words * 8 / HBM_BYTES_PER_S * 1e3), chunks


def check_nms(torch, k5, dev, seed):
    """K5 at the three NMS shapes (``NMS_SHAPES``) on ``nms_scene``, with
    f32 and bf16 scores, with ``valid`` and with None, and on
    ``nms_edge_cases`` likewise: keep masks equal to
    ``box_nms_topk_plain``'s, and the planted cases as greedy NMS must
    give them. Timed warm and cold at each shape (f32 scores:
    ``detection_ms``, ...), the record's ``ms`` at the proposal shape;
    bound from bytes, and beside it two floors: the pick-argmax form's
    latency floor (the picks of the longest image times one empty
    block-wide argmax round on the card: the earlier design's measure,
    kept so records stay comparable) and this design's
    (``nms_design_floor``)."""
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
    for label, boxes, scores, valid, keep, thr in nms_edge_cases(
            torch, dev, g):
        for dtype in (torch.float32, torch.bfloat16):
            sc = scores.to(dtype)
            for v in ((valid, None) if valid is not None else (None,)):
                got = k5.box_nms_topk(boxes, sc, thr, v, keep)
                ref = k5.box_nms_topk_plain(boxes, sc, thr, v, keep)
                case = (f"{label}_{str(dtype)[6:]}_"
                        f"{'valid' if v is not None else 'no_valid'}")
                errs[case] = float((got != ref).sum())
                if errs[case]:
                    fail(f"K5 {case}: keep mask differs from the plain "
                         f"version at {int(errs[case])} candidates")
                if label == "keep_above_alive" and not bool(
                        (got.sum(1) < keep).all()):
                    fail(f"K5 {case}: {got.sum(1).tolist()} picks")
                if label == "nan_scores_boxes" and (
                        bool(got[:, ::7].any()) or not bool(
                            (got | sc.isnan())[:, 3::11].all())):
                    fail(f"K5 {case}: a NaN score kept or a NaN box "
                         f"suppressed")
    rounds = {t: argmax_round_ms(torch, dev, t) for t in (256, 1024)}
    for label, e in extra.items():
        e["latency_floor_ms"] = e["picks_longest_image"] * rounds[
            256 if e["candidates"] <= 256 else 1024]
        boxes, scores, valid, keep, thr = scenes[label]
        e["design_floor_ms"], e["scan_chunks_longest_image"] = \
            nms_design_floor(torch, boxes, scores, valid, k5.box_nms_topk(
                boxes, scores, thr, valid, keep), keep, rounds)
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
                design_floor_ms=extra["proposal"]["design_floor_ms"],
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
    """Every launch counter to 0, each K3 instantiation's and K3b's
    included."""
    for k in ("k1", "k2", "k3", "k3q", "k4", "k5"):
        mods[k].LAUNCHES = 0
    mods["k3"].BACKWARD_LAUNCHES = 0
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
              "box_nms_topk": mods["k5"].LAUNCHES,
              "roi_align_backward": mods["k3"].BACKWARD_LAUNCHES}
    counts.update({ROI_RECORDS[v]: n
                   for v, n in mods["k3"].LAUNCHES_BY_TYPE.items()})
    return counts


@contextlib.contextmanager
def plain_versions(mods):
    """Route the seven kernel entry points to their plain versions (the
    comparison runs only)."""
    entries = [(mods["k1"], "heatmap_peaks"), (mods["k2"], "affine_crop"),
               (mods["k3"], "roi_align"), (mods["k3q"], "quantize_levels"),
               (mods["k4"], "warp_two_pass"), (mods["k5"], "box_nms_topk"),
               (mods["k3"], "roi_align_backward")]
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


# --------------------------------------------------------------- vase path
# The qualitative vase engine behind 04_evaluate_vases_qualitatively.py
# (VaseEvaluator) at full width: phase 4's seeded detector and HRNet-W32
# saved as a temporary experiment's checkpoints "final", vase images of
# seeded source sizes letterboxed in memory (the card's machine has no
# cv2), 04's batch of 1 and the serving batch of B.
VASE_DETECTOR = "faster_rcnn"
VASE_PARITY = "faster_rcnn_torchvision_parity"
VASE_POSE = "w32_256x192"
VASE_CLI_IMAGES, VASE_BATCH_IMAGES = 11, 13
VASE_SOURCE = (240, 640)            # source sides before the letterbox


def vase_canvas(seed, image_id, S):
    """A seeded uint8 source image of 240-640 x 240-640 px resized
    (nearest) to a longest side of S and zero-padded to S x S, in [0, 1]
    as the vase pipeline gives it; and the resize factor."""
    rng = np.random.RandomState(seed * 7919 + image_id)
    h, w = (int(v) for v in rng.randint(VASE_SOURCE[0], VASE_SOURCE[1] + 1,
                                        2))
    src = rng.randint(0, 256, (h, w, 3), np.uint8)
    scale = S / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    rows = np.minimum((np.arange(nh) / scale).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(nw) / scale).astype(np.int64), w - 1)
    canvas = np.zeros((S, S, 3), np.float32)
    canvas[:nh, :nw] = src[rows][:, cols] / np.float32(255.0)
    return canvas, scale


@contextlib.contextmanager
def vase_canvases_in_memory(mods, seed):
    """Every DetectionDataPipeline reads its records as ``vase_canvas``
    images from memory, not as JPEG files."""
    cls = mods["DetectionDataPipeline"]
    saved = cls._load_one

    def load(self, rec):
        canvas, scale = vase_canvas(seed, rec.image_id, self.img_size)
        n = self.max_boxes
        return (canvas, np.zeros((n, 4), np.float32),
                np.zeros((n,), np.int32), np.zeros((n,), np.float32),
                np.float32(scale), np.int64(rec.image_id), np.float32(0.0))

    cls._load_one = load
    try:
        yield
    finally:
        cls._load_one = saved


def vase_folder(root, name, n):
    """``root``/``name`` holding ``n`` empty image files: the records of
    the vase pipeline (``vase_canvases_in_memory`` gives their pixels)."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        open(os.path.join(d, f"vase_{i:04d}.jpg"), "wb").close()
    return d


def vase_engine(mods, exp_path, data, dev, batch_size=1, **kw):
    """VaseEvaluator as 04's main builds it, on the experiment's pose and
    detector checkpoints "final", HRNet VASE_POSE, without drawing."""
    ev = mods["VaseEvaluator"](exp_path, checkpoint="final",
                               detector_checkpoint="final",
                               dataset_name="vases_cli", data_path=data,
                               save=False, device=dev,
                               **{"detector_config": VASE_DETECTOR, **kw})
    ev.load_vase_subset(batch_size=batch_size)
    ev.setup_models(config_name=VASE_POSE, pretrained=None)
    return ev


@contextlib.contextmanager
def calls_to(module, name, log):
    """Append (args, kwargs, output) of every call of ``module.name`` to
    ``log``."""
    fn = getattr(module, name)

    def logged(*a, **kw):
        out = fn(*a, **kw)
        log.append((a, kw, out))
        return out

    setattr(module, name, logged)
    try:
        yield
    finally:
        setattr(module, name, fn)


def result_diffs(got, ref):
    """Largest differences between two ``process_images`` results, image
    by image: boxes, scores, keypoint coordinates (crop and image) and
    keypoint scores; None where the per-image counts differ."""
    if [len(r["boxes"]) for r in got] != [len(r["boxes"]) for r in ref]:
        return None
    d = dict.fromkeys(("boxes", "scores", "crop_xy", "image_xy",
                       "kpt_scores"), 0.0)
    for g, r in zip(got, ref):
        if not len(r["boxes"]):
            continue
        pairs = {"boxes": (g["boxes"], r["boxes"]),
                 "scores": (g["scores"], r["scores"]),
                 "crop_xy": (g["crop_keypoints"][..., :2],
                             r["crop_keypoints"][..., :2]),
                 "image_xy": (g["image_keypoints"][..., :2],
                              r["image_keypoints"][..., :2]),
                 "kpt_scores": (
                     np.concatenate([g["crop_keypoints"][..., 2],
                                     g["image_keypoints"][..., 2]]),
                     np.concatenate([r["crop_keypoints"][..., 2],
                                     r["image_keypoints"][..., 2]]))}
        for k, (a, b) in pairs.items():
            d[k] = max(d[k], float(np.abs(np.asarray(a, np.float64) -
                                          np.asarray(b, np.float64)).max()))
    return d


def results_ok(results, n, J=17):
    """``n`` results of finite boxes, scores and keypoints of their
    shapes."""
    return len(results) == n and all(
        r["boxes"].shape == (len(r["scores"]), 4)
        and r["crop_keypoints"].shape == r["image_keypoints"].shape ==
        (len(r["scores"]), J, 3)
        and all(np.isfinite(r[k]).all() for k in r) for r in results)


def tied_scores(results):
    """Detections whose score equals an earlier one of the same image."""
    return sum(len(r["scores"]) - len(np.unique(r["scores"]))
               for r in results)


def host_ms(torch, fn, iters):
    """Host-clock ms per call of ``fn`` over ``iters`` calls after one
    warm-up call, synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def in_turns(torch, fns, iters, rounds=2):
    """Host ms per call of each of ``fns`` (label -> function), timed in
    turns a, b, b, a, ... so that drift falls on each alike."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]) * rounds:
        for k in order:
            times[k].append(host_ms(torch, fns[k], iters))
    return {k: float(np.mean(v)) for k, v in times.items()}


def engine_split(torch, ev, images, iters):
    """One engine call at a batch, split on the host clock (synchronised
    between parts): the upload, the fused program, the fetch + unpack."""
    f, spec = ev._get_fused(len(images), ev._fused_budget(len(images)))
    parts = {"upload_ms": 0.0, "fused_program_ms": 0.0,
             "fetch_unpack_ms": 0.0}
    with torch.inference_mode():
        for i in range(iters + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = ev._upload(images)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            buf = f(x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ev._unpack(buf, spec)
            t3 = time.perf_counter()
            if i:                                   # the first is a warm-up
                for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                    parts[k] += dt * 1e3 / iters
    return parts


def proposal_candidates(cfg):
    """Candidates of the proposal NMS of ``select_proposals``: each level's
    top ``pre_nms_top_n_test`` of its h * w * anchors logits."""
    S, A = cfg.image_size, len(cfg.anchor_ratios)
    return sum(min(cfg.pre_nms_top_n_test, (-(-S // st)) ** 2 * A)
               for st in cfg.strides)


def vase_path(torch, mods, dev, args, tmp, state):
    """The qualitative vase engine at full width (phase 4c): phase 4's
    seeded models saved as the experiment's checkpoints "final" and
    loaded by VaseEvaluator as 04's main loads them, the pipeline's
    images from memory, no drawing. Counters set to 0, then 04's traffic
    (``qualitative_comparison`` over VASE_CLI_IMAGES records at B = 1), a
    serving batch (``process_images`` on B canvases, B - 1 of them
    images), VASE_BATCH_IMAGES records at B (a short tail batch): K1
    (bulk), K2, K3 f32 and K5 (twice a fused call) launched. Then, at a
    ``bbox_thr`` that makes the per-image counts vary: the fused engine
    against its host path (boxes 1e-4, scores 1e-5, keypoints 1e-3) and
    against itself on the plain versions; the quantized bf16 flavor (K3q
    and K3 int8 -> bf16 launched, kernels against plain versions, tied
    scores counted); the torchvision-parity detector (K5 on its proposal
    candidates, in shared memory, and K3 on B x 1000 boxes, each against
    its plain version on that call's inputs). Times on the host clock,
    the in-memory pipeline's own ms per image beside 04's.
    Returns ({path: launches}, summary, profile state)."""
    det, pose, bare_fused, bare_images, _ = state
    t0 = time.time()
    data = os.path.join(tmp, "data")
    vase_folder(data, "vases_cli", VASE_CLI_IMAGES)
    vase_folder(data, "vases_batch", VASE_BATCH_IMAGES)
    exp_path = mods["create_experiment"]("chip_smoke_vase", {},
                                         root=os.path.join(tmp, "exp"))
    exp = mods["load_experiment_parameters"](exp_path)
    mods["save_checkpoint"](mods["create_train_state"](pose, exp), exp_path,
                            "final")
    mods["save_checkpoint"](mods["create_train_state"](det, exp), exp_path,
                            "final", detector=True)
    paths = {}
    with vase_canvases_in_memory(mods, args.seed + 40):
        ev = vase_engine(mods, exp_path, data, dev)
        S, m = ev.det_cfg.image_size, ev.max_dets
        canvases = np.stack([vase_canvas(args.seed + 41, i, S)[0]
                             for i in range(B)])
        canvases[-1] = 0.0                      # B - 1 images, one empty
        print(f"vase set-up in {time.time() - t0:.1f} s", flush=True)
        for b in (1, B, VASE_BATCH_IMAGES % B):           # cuDNN plans
            ev.process_images(canvases[:b])
        torch.cuda.synchronize()

        reset_counts(mods)
        n_cli = ev.qualitative_comparison(limit=VASE_CLI_IMAGES)
        res8 = ev.process_images(canvases)
        cli_pipe = ev.pipe
        ev.pipe = mods["get_vase_subset"](img_size=S,
                                          dataset_name="vases_batch",
                                          data_path=data, batch_size=B)
        n_batch = ev.qualitative_comparison()
        torch.cuda.synchronize()
        paths["vase"] = launch_counts(mods)
        print("vase-path launches:", json.dumps(paths["vase"]))
        calls = VASE_CLI_IMAGES + 1 + -(-VASE_BATCH_IMAGES // B)
        if (n_cli, n_batch, len(ev.pipe)) != (
                VASE_CLI_IMAGES, VASE_BATCH_IMAGES, 2) or \
                not results_ok(res8, B):
            fail(f"vase: {n_cli} and {n_batch} images, "
                 f"{len(ev.pipe)} batches, results_ok "
                 f"{results_ok(res8, B)}")
        if min(paths["vase"][k] for k in ("heatmap_peaks", "affine_crop",
                                          "roi_align")) < 1 or \
                paths["vase"]["box_nms_topk"] != 2 * calls:
            fail(f"vase: a kernel of the path was not launched, or K5 not "
                 f"twice in each of {calls} fused calls: {paths['vase']}")
        k1_took_bulk(mods, "vase")

        # a threshold at the median of the candidates' scores (each image's
        # top max_dets person scores of one predict), so counts vary
        with torch.inference_mode():
            d = ev.detector.predict(torch.from_numpy(canvases).to(dev))
        ps = torch.where(d["valid"] & (d["labels"] == 1), d["scores"],
                         -torch.inf).float()
        top = ps.topk(m, dim=1).values
        thr = float(top[top > -torch.inf].median())
        ev_thr = vase_engine(mods, exp_path, data, dev, bbox_thr=thr)
        fused = ev_thr.process_images(canvases)
        host = ev_thr.process_images(canvases, use_fused=False)
        counts = [len(r["boxes"]) for r in host]
        vs_host = result_diffs(fused, host)
        print(f"vase: bbox_thr {thr:.6f}, detections per image {counts}; "
              f"fused vs host path:", json.dumps(vs_host), flush=True)
        if len(set(counts)) < 2 or not results_ok(fused, B):
            fail(f"vase: counts {counts} do not vary")
        # the JAX package's fused-vs-host tolerances
        if vs_host is None or not (
                vs_host["boxes"] <= 1e-4 and vs_host["scores"] <= 1e-5 and
                max(vs_host["crop_xy"], vs_host["image_xy"],
                    vs_host["kpt_scores"]) <= 1e-3):
            fail(f"vase: fused engine disagrees with its host path: "
                 f"{vs_host}")

        def vs_plain(engine, label):
            with plain_versions(mods):
                ref = engine.process_images(canvases)
            torch.cuda.synchronize()
            diffs = result_diffs(engine.process_images(canvases), ref)
            print(f"{label}, kernels vs plain versions:", json.dumps(diffs))
            # as phase 4: keypoints and boxes 1e-3 px, peaks 1e-4; scores
            # 1e-5
            if diffs is None or not (
                    diffs["boxes"] <= 1e-3 and diffs["scores"] <= 1e-5 and
                    max(diffs["crop_xy"], diffs["image_xy"]) <= 1e-3 and
                    diffs["kpt_scores"] <= 1e-4):
                fail(f"{label} disagrees with its plain-version run: "
                     f"{diffs}")
            return diffs

        plain_f32 = vs_plain(ev_thr, "vase f32 engine")

        ev16 = vase_engine(mods, exp_path, data, dev, bbox_thr=thr,
                           dtype=torch.bfloat16, trunk_quant="folded",
                           roi_patch_quant=True)
        ev16.process_images(canvases)
        torch.cuda.synchronize()
        reset_counts(mods)
        out16 = ev16.process_images(canvases)
        torch.cuda.synchronize()
        paths["vase_bf16_roi8"] = launch_counts(mods)
        print("vase bf16 launches:", json.dumps(paths["vase_bf16_roi8"]))
        if min(paths["vase_bf16_roi8"][k] for k in (
                "heatmap_peaks", "affine_crop", "quantize_levels",
                "roi_align_i8_bf16")) < 1 or \
                paths["vase_bf16_roi8"]["box_nms_topk"] != 2 or \
                not results_ok(out16, B):
            fail(f"vase bf16: {paths['vase_bf16_roi8']}")
        plain_bf16 = vs_plain(ev16, "vase bf16 engine")
        ties16 = tied_scores(out16)

        evp = vase_engine(mods, exp_path, data, dev, bbox_thr=thr,
                          detector_config=VASE_PARITY)
        evp.process_images(canvases)
        torch.cuda.synchronize()
        nms_calls, roi_calls = [], []
        reset_counts(mods)
        with calls_to(mods["k5"], "box_nms_topk", nms_calls), \
                calls_to(mods["k3"], "roi_align", roi_calls):
            outp = evp.process_images(canvases)
        torch.cuda.synchronize()
        paths["vase_tv_parity"] = launch_counts(mods)
        cfg = evp.det_cfg
        M = proposal_candidates(cfg)
        shapes = {"nms": [tuple(a[1].shape) for a, _, _ in nms_calls],
                  "roi_boxes": [tuple(a[1].shape) for a, _, _ in roi_calls]}
        print("vase torchvision parity:", json.dumps(
            {"launches": paths["vase_tv_parity"], **shapes}), flush=True)
        if shapes != {"nms": [(B, M), (B, cfg.post_nms_top_n_test)],
                      "roi_boxes": [(B, cfg.post_nms_top_n_test, 4)]} or \
                not results_ok(outp, B):
            fail(f"vase torchvision parity: {shapes}, M = {M}")
        k5, k3 = mods["k5"], mods["k3"]
        parity = {"proposal_candidates": M,
                  "nms_mismatches": [int((out != k5.box_nms_topk_plain(
                      *a, **kw)).sum()) for a, kw, out in nms_calls]}
        (ra, rkw, rout), = roi_calls
        parity["roi_align_max_abs_err"] = float(
            (rout - k3.roi_align_plain(*ra, **rkw)).abs().max())
        print("vase torchvision parity, K5 and K3 vs plain versions:",
              json.dumps(parity), flush=True)
        if any(parity["nms_mismatches"]) or \
                parity["roi_align_max_abs_err"] > 1e-5:
            fail(f"vase torchvision parity: kernels disagree with their "
                 f"plain versions on the call's inputs: {parity}")
        (na, nkw, _), _ = nms_calls
        parity["k5_proposals_ms"] = elapsed_ms(
            torch, lambda: k5.box_nms_topk(*na, **nkw), 20)
        parity["k5_proposals_plain_ms"] = elapsed_ms(
            torch, lambda: k5.box_nms_topk_plain(*na, **nkw), 2)
        parity["k3_ms"] = elapsed_ms(torch, lambda: k3.roi_align(*ra, **rkw),
                                     20)
        parity["k3_plain_ms"] = elapsed_ms(
            torch, lambda: k3.roi_align_plain(*ra, **rkw), 2)
        del nms_calls, roi_calls, na, nkw, ra, rkw, rout

        # times, host clock; 04's traffic at B = 1, then B
        ev.pipe = cli_pipe
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev.qualitative_comparison(limit=VASE_CLI_IMAGES)
        torch.cuda.synchronize()
        b1_ms = (time.perf_counter() - t) * 1e3 / VASE_CLI_IMAGES
        t = time.perf_counter()
        n_piped = sum(bt["n_valid"] for bt in cli_pipe)
        pipe_ms = (time.perf_counter() - t) * 1e3 / n_piped
        one = canvases[:1]
        b1_call_ms = host_ms(torch, lambda: ev.process_images(one),
                             args.iters)
        turns = in_turns(torch, {
            "bare_fused_call": lambda: bare_fused(bare_images),
            "engine": lambda: ev_thr.process_images(canvases)}, args.iters)
        split = engine_split(torch, ev_thr, canvases, args.iters)
        turns_host = in_turns(torch, {
            "engine": lambda: ev_thr.process_images(canvases),
            "host_path": lambda: ev_thr.process_images(canvases,
                                                       use_fused=False)},
            args.iters, rounds=1)
        bf16_ms = host_ms(torch, lambda: ev16.process_images(canvases),
                          args.iters)
        parity_ms = host_ms(torch, lambda: evp.process_images(canvases),
                            args.iters)
    summary = {
        "batch": B, "max_dets": m, "budget": ev_thr._fused_budget(B),
        "cli_images": VASE_CLI_IMAGES, "batch_images": VASE_BATCH_IMAGES,
        "fused_calls": calls, "bbox_thr": thr, "counts": counts,
        "engine_b1_ms_per_image": b1_ms, "engine_b1_ms_per_call": b1_call_ms,
        "pipeline_b1_ms_per_image": pipe_ms,
        "engine_b8_ms": turns["engine"],
        "bare_fused_call_b8_ms": turns["bare_fused_call"],
        "engine_over_bare": turns["engine"] / turns["bare_fused_call"],
        "engine_b8_split": split,
        "host_path_b8_ms": turns_host["host_path"],
        "engine_b8_ms_beside_host_path": turns_host["engine"],
        "bf16_engine_b8_ms": bf16_ms, "bf16_tied_scores": ties16,
        "tv_parity_b8_ms": parity_ms, "tv_parity": parity,
        "fused_vs_host": vs_host, "kernels_vs_plain_f32": plain_f32,
        "kernels_vs_plain_bf16": plain_bf16}
    print("vase:", json.dumps(summary), flush=True)
    del ev16, evp
    return paths, summary, (ev, ev_thr, canvases, b1_call_ms,
                            turns["engine"])


def train_path(torch, mods, dev, args):
    """Pose training at full width: seeded HRNet-W32, Adam, batches from
    the device-warp collate (host samples made first, as the decode
    threads would), 2 warm-up iterations, then TRAIN_STEPS timed ones,
    one eval step and one scheduler step with every launch counter set to
    0 first; K1 against its plain version on the last timed step's own
    heatmaps; the step with and without model.train() before it, in
    turns; then one step on the kernels against the same step on the
    plain versions. Returns (launches, summary, {form: iteration})."""
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

    # the train-mode guard: a step on a model already in train mode
    # against the same step with model.train() before it, as every step
    # ran before the guard (host clock, synchronised, in turns)
    forms = {"guarded": lambda: iteration(raw[0]),
             "model_train_each_step": lambda: (model.train(),
                                               iteration(raw[0]))}
    forms["guarded"]()                  # back to train mode after eval
    guard = {form: [] for form in forms}
    for order in (list(forms), list(forms)[::-1]) * 2:
        for form in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            forms[form]()
            torch.cuda.synchronize()
            guard[form].append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    model.train()
    guard["model_train_call_ms"] = (time.perf_counter() - t) * 1e3
    print("training step, train-mode guard (ms):", json.dumps(guard))

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
               "kernels_vs_plain": vs_plain, "train_mode_guard_ms": guard}
    print("training:", json.dumps(summary), flush=True)
    return launches, summary, forms


# ---------------------------------------------------------------- eval path
# Flip-TTA evaluation: the batch of the JAX README's flip-TTA row, 256
# COCO-layout images of CANVAS x CANVAS (the letterbox size: no cv2) with
# two people each, so 8 full batches of 64 crops (128 through HRNet)
EVAL_B, EVAL_IMAGES, EVAL_PEOPLE = 64, 256, 2
EVAL_CONFIG = "w32_256x192"
ORACLE_MIN = 0.95               # AP and AR, as tests/test_oracle_ap.py


def coco_people(rng, ids):
    """COCO-layout images and person annotations for the image ``ids``,
    from ``rng``: CANVAS x CANVAS uint8 canvases, EVAL_PEOPLE people on
    each (boxes of 80-240 x 160-400 px, 17 keypoints inside, 80% labelled
    visible). Returns (images, annotations, {image_id: canvas})."""
    canvases = rng.randint(0, 256, (len(ids), CANVAS, CANVAS, 3), np.uint8)
    images, anns = [], []
    for img_id in ids:
        images.append({"id": img_id, "height": CANVAS, "width": CANVAS,
                       "file_name": "%012d.jpg" % img_id})
        for _ in range(EVAL_PEOPLE):
            w, h = rng.uniform(80, 240), rng.uniform(160, 400)
            x, y = rng.uniform(0, CANVAS - w), rng.uniform(0, CANVAS - h)
            vis = np.where(rng.rand(17) > 0.2, 2.0, 0.0)
            kp = np.stack([x + rng.rand(17) * w, y + rng.rand(17) * h, vis],
                          -1)
            anns.append({"id": len(anns) + 1, "image_id": img_id,
                         "category_id": 1, "bbox": [x, y, w, h],
                         "area": w * h, "iscrowd": 0,
                         "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": int((vis > 0).sum())})
    return images, anns, dict(zip(ids, canvases))


def write_keypoints_file(root, split, images, anns):
    """``root``/annotations/person_keypoints_``split``.json."""
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations",
                           f"person_keypoints_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)


def eval_dataset(root, seed):
    """``root``/annotations/person_keypoints_val.json in COCO layout, from
    ``seed``: EVAL_IMAGES images (``coco_people``). Returns {image_id:
    uint8 canvas}, the decoded images."""
    rng = np.random.RandomState(seed)
    images, anns, canvases = coco_people(
        rng, [1000 + i for i in range(EVAL_IMAGES)])
    write_keypoints_file(root, "val", images, anns)
    return canvases


def eval_evaluator(torch, mods, exp_path, data, canvases, dev, dtype):
    """The port's PoseEvaluator on the experiment's "final" checkpoint,
    HRNet-W32 in ``dtype``, its valid pipeline reading the decoded
    canvases from memory in place of JPEG files."""
    ev = mods["PoseEvaluator"](exp_path, checkpoint="final", data_path=data,
                               flip=True, dtype=dtype, device=dev)
    ev.setup_model_dataset(config_name=EVAL_CONFIG, pretrained=None)
    pipe = ev.valid_pipe
    pipe._load_one_raw = lambda rec: pipe._letterbox(canvases[rec.image_id],
                                                     rec)
    return ev


def timed_evaluation(torch, ev, evaluator_mod):
    """One evaluate_model on the host clock, with the host seconds of its
    submission writes and of its COCO scoring."""
    host = {"generate_submission_s": 0.0, "compute_precision_s": 0.0}
    saved = {k: getattr(evaluator_mod, k) for k in
             ("generate_submission", "compute_precision")}

    def timer(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name + "_s"] += time.perf_counter() - t
        return call

    for k, fn in saved.items():
        setattr(evaluator_mod, k, timer(k, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = ev.evaluate_model()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(evaluator_mod, k, fn)
    n = len(ev.valid_pipe.records)
    return stats, {"ms_per_batch": dt * 1e3 / len(ev.valid_pipe),
                   "crops_per_s": n / dt, "evaluation_s": dt, **host}


def eval_stats_ok(stats, exp_path, ev, label):
    """10 finite stats, written to the stats JSON under the checkpoint."""
    if stats.shape != (10,) or not np.isfinite(stats).all():
        fail(f"{label}: stats {stats}")
    files = [f for f in os.listdir(exp_path)
             if f.startswith("evaluation_stats")]
    with open(os.path.join(exp_path, files[0])) as f:
        if str(ev.checkpoint) not in json.load(f):
            fail(f"{label}: the stats JSON is not keyed by checkpoint")


def eval_decode_njhw(torch, mods, model):
    """The fused eval step with the flip-TTA combine in the (N, J, H, W)
    layout (``average_flip_tta`` on the permuted halves) and one contiguous
    copy of its result feeding the loss, PCK and decode;
    make_eval_decode_step combines in the model's (N, H, W, J) view, as
    the reference does."""
    steps = mods["steps"]

    def step(batch):
        with torch.no_grad():
            images = batch["image"]
            n = images.shape[0]
            out = model(torch.cat([images, torch.flip(images, dims=[2])]))
            out = out.permute(0, 3, 1, 2)
            pred = mods["average_flip_tta"](out[:n], out[n:]).contiguous()
            metrics = steps._eval_metrics(pred, batch)
            preds, maxvals, _ = mods["decode_heatmaps"](
                pred, batch["center"], batch["scale"])
            return torch.cat([preds, maxvals[..., None]], -1), metrics

    return step


def eval_path(torch, mods, dev, args, tmp):
    """Flip-TTA COCO evaluation through the port's PoseEvaluator at full
    width: HRNet-W32 256x192 in f32 (seeded weights saved as the
    experiment's "final" checkpoint), B = 64, 512 crops. Every counter
    set to 0, one evaluate_model (K4 and K1 must launch; stats checked),
    a second one timed; one batch split into collate (K4), the fused step
    (CUDA events) and the host consume; the step without flip; the step
    with the flip combine in the (N, J, H, W) layout (K1's kernel and time
    of each form);
    the step on the kernels against the same step on the plain versions;
    the oracle AP (the batches' own target heatmaps decoded and scored);
    the bf16 flavor's ms per batch and drift. Returns (launches, summary,
    (step, device batch, step ms))."""
    k1 = mods["k1"]
    t0 = time.time()
    data = os.path.join(tmp, "data")
    canvases = eval_dataset(data, args.seed + 20)
    exp_path = mods["create_experiment"](
        "chip_smoke_eval", {"batch_size": EVAL_B, "dataset_name": "coco",
                            "device_warp": True},
        root=os.path.join(tmp, "experiments"))
    model = seeded_weights(torch, mods["PoseHighResolutionNet"](
        mods["get_hrnet_config"](EVAL_CONFIG), device=dev), args.seed + 6)
    exp = mods["load_experiment_parameters"](exp_path)
    mods["save_checkpoint"](mods["create_train_state"](model, exp),
                            exp_path, "final")
    del model
    ev = eval_evaluator(torch, mods, exp_path, data, canvases, dev,
                        torch.float32)
    evaluator_mod = sys.modules[type(ev).__module__]
    pipe = ev.valid_pipe
    n_crops = len(pipe.records)
    if n_crops != EVAL_IMAGES * EVAL_PEOPLE or len(pipe) * EVAL_B != n_crops:
        fail(f"eval: {n_crops} records in {len(pipe)} batches")
    print(f"eval set-up in {time.time() - t0:.1f} s", flush=True)

    reset_counts(mods)
    stats = ev.evaluate_model()
    torch.cuda.synchronize()
    launches = launch_counts(mods)
    print("eval-path launches:", json.dumps(launches))
    if launches["warp_two_pass"] < 1 or launches["heatmap_peaks"] < 1:
        fail(f"a kernel of the eval path was not launched: {launches}")
    k1_took_bulk(mods, "eval")
    eval_stats_ok(stats, exp_path, ev, "eval")
    stats2, timing = timed_evaluation(torch, ev, evaluator_mod)
    print("eval, whole evaluation:", json.dumps(timing), flush=True)

    # one batch, split
    recs = pipe.records[:EVAL_B]
    samples = [pipe._load_one_raw(r) for r in recs]
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch = pipe._collate_device_warp(samples, recs)
    devb = mods["device_batch"](batch, dev)
    torch.cuda.synchronize()
    collate_ms = (time.perf_counter() - t) * 1e3
    step = ev.eval_decode
    step_ms = elapsed_ms(torch, lambda: step(devb), 3)
    preds, _ = step(devb)
    torch.cuda.synchronize()
    ev._pending_host, ev._write_every = ([], [], []), 1 << 30
    t = time.perf_counter()
    ev.consume(preds, batch)
    consume_ms = (time.perf_counter() - t) * 1e3
    no_flip = mods["make_eval_decode_step"](ev.model, flip_tta=False)
    no_flip_ms = elapsed_ms(torch, lambda: no_flip(devb), 3)

    # K1's kernel and the step's time in each layout of the combine, timed
    # in turns (a, b, b, a, ...) so that drift falls on both alike
    fns = {"nhwc_view": step,
           "njhw_contiguous": eval_decode_njhw(torch, mods, ev.model)}
    forms, outs = {}, {}
    for form, fn in fns.items():
        reset_counts(mods)
        outs[form] = fn(devb)
        torch.cuda.synchronize()
        forms[form] = {"k1_kernels": dict(k1.LAUNCHES_BY_KERNEL),
                       "step_ms": []}
    for order in (list(fns), list(fns)[::-1]) * 2:
        for form in order:
            forms[form]["step_ms"].append(
                elapsed_ms(torch, lambda f=fns[form]: f(devb), 3))
    a, b = outs["nhwc_view"], outs["njhw_contiguous"]
    forms["max_abs_diff_between_forms"] = float((a[0] - b[0]).abs().max())
    split = {"batch": EVAL_B, "crops_through_hrnet": 2 * EVAL_B,
             "collate_upload_k4_ms": collate_ms, "eval_decode_step_ms": step_ms,
             "consume_ms": consume_ms, "eval_decode_step_no_flip_ms":
             no_flip_ms, "flip_cost_ms": step_ms - no_flip_ms,
             "k1_forms": forms}
    print("eval, one batch:", json.dumps(split), flush=True)

    # the step (with its collate) on the kernels and on the plain versions
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for plain in (False, True):
            peaks = []
            with (plain_versions(mods) if plain
                  else contextlib.nullcontext()), recording(k1, peaks):
                bt = pipe._collate_device_warp(samples, recs)
                kp, m = step(mods["device_batch"](bt, dev))
            torch.cuda.synchronize()
            runs.append((bt["image"], kp, {k: float(v) for k, v in m.items()},
                         peaks))
    finally:
        torch.backends.cudnn.deterministic = False
    (xk, kk, mk, pk), (xp, kp_, mp, _) = runs
    k1_exact = [all(torch.equal(g, r) for g, r in
                    zip(out, k1.heatmap_peaks_plain(hm))) for hm, out in pk]
    vs_plain = {"crops_max_abs_diff": float((xk - xp).abs().max()),
                "kpts_max_abs_diff_px": float((kk[..., :2] - kp_[..., :2])
                                              .abs().max()),
                "maxvals_max_abs_diff": float((kk[..., 2] - kp_[..., 2])
                                              .abs().max()),
                "metrics_kernels": mk, "metrics_plain": mp,
                "k1_calls_equal_to_plain": k1_exact}
    print("eval step, kernels vs plain versions:", json.dumps(vs_plain))
    # K4 0 expected (1e-4 on the 0-255 scale), keypoints 1e-3 px, maxima
    # 1e-4, loss and PCK exact, K1 on the step's own heatmaps exact
    if not (vs_plain["crops_max_abs_diff"] <= 1e-4 / 255 / float(mods["IMAGENET_STD"].min())
            and vs_plain["kpts_max_abs_diff_px"] <= 1e-3
            and vs_plain["maxvals_max_abs_diff"] <= 1e-4 and mk == mp
            and len(k1_exact) == 3 and all(k1_exact)):
        fail(f"eval step disagrees with its plain-version run: {vs_plain}")

    # oracle: the batches' own target heatmaps in place of the network's
    all_preds, all_boxes, image_ids = [], [], []
    for bt in pipe:
        n = bt["n_valid"]
        p, mv, _ = mods["decode_heatmaps"](
            bt["target"][:n], torch.from_numpy(bt["center"][:n]).to(dev),
            torch.from_numpy(bt["scale"][:n]).to(dev))
        all_preds.append(torch.cat([p, mv[..., None]], -1).cpu().numpy())
        area = np.prod(bt["scale"][:n] * 200.0, axis=1)
        all_boxes.append(np.concatenate(
            [bt["center"][:n], bt["scale"][:n], area[:, None],
             bt["score"][:n, None]], axis=1))
        image_ids.extend(bt["image_id"][:n].tolist())
    oracle_file = os.path.join(tmp, "oracle_submission.json")
    mods["generate_submission"](np.concatenate(all_preds),
                                np.concatenate(all_boxes), image_ids,
                                oracle_file)
    oracle = mods["compute_precision"](oracle_file, os.path.join(
        data, "annotations", "person_keypoints_val.json"))
    print("eval oracle AP / AR:", float(oracle[0]), float(oracle[5]))
    if not (oracle[0] >= ORACLE_MIN and oracle[5] >= ORACLE_MIN):
        fail(f"oracle AP {oracle[0]}, AR {oracle[5]}: below {ORACLE_MIN}")

    # the bf16 flavor on the same checkpoint
    f32_preds = json.load(open(ev.preds_file))
    ev16 = eval_evaluator(torch, mods, exp_path, data, canvases, dev,
                          torch.bfloat16)
    stats16 = ev16.evaluate_model()
    eval_stats_ok(stats16, exp_path, ev16, "eval bf16")
    _, timing16 = timed_evaluation(torch, ev16, evaluator_mod)
    bf16_preds = json.load(open(ev16.preds_file))

    def by_person(preds):
        return {(p["image_id"], *p["center"]): np.reshape(
            p["keypoints"], (17, 3))[:, :2] for p in preds}

    f32_by, bf16_by = by_person(f32_preds), by_person(bf16_preds)
    both = sorted(set(f32_by) & set(bf16_by))
    drift = {"kpts_mean_abs_diff_px": float(np.mean(
        [np.abs(f32_by[k] - bf16_by[k]).mean() for k in both])),
             "persons_f32": len(f32_preds), "persons_bf16": len(bf16_preds),
             "persons_in_both": len(both),
             "stats_f32": stats2.tolist(), "stats_bf16": stats16.tolist()}
    print("eval bf16:", json.dumps({**timing16, "drift_from_f32": drift}),
          flush=True)

    summary = {"batch": EVAL_B, "crops": n_crops, "batches": len(pipe),
               **timing, "one_batch": split, "kernels_vs_plain": vs_plain,
               "oracle_ap": float(oracle[0]), "oracle_ar": float(oracle[5]),
               "stats": stats2.tolist(),
               "bf16": {**timing16, "drift_from_f32": drift}}
    print("eval:", json.dumps({k: v for k, v in summary.items()
                               if k not in ("one_batch", "bf16",
                                            "kernels_vs_plain")}), flush=True)
    return launches, summary, (fns, devb, forms)


# ------------------------------------------------------------ trainer path
# The training CLI, 01 -> 02 -> 03, through PoseTrainer at full width
# (HRNet-W32 256x192, B = 32): Styled-COCO with perceptual-loss
# weighting, 128 train and 80 valid images of CANVAS x CANVAS with two
# people each, so 8 train batches an epoch and 1 validation batch
# (max(1, 5 // 5)); the COCO augmentation of the training path (AUG)
ENGINE_TRAIN_IMAGES, ENGINE_VALID_IMAGES = 128, 80
ENGINE_CONFIG = "w32_256x192"
STYLES, ALPHA = "redblack", "0.5"


def engine_dataset(root, dict_root, seed, n_train=ENGINE_TRAIN_IMAGES,
                   n_valid=ENGINE_VALID_IMAGES):
    """The Styled-COCO layout from ``seed``: the train and val keypoint
    files of ``n_train`` and ``n_valid`` images (``coco_people``), the
    styled-name mapping dicts, and the per-image perceptual losses
    (uniform in 0.1-2.5) under ``dict_root``. Returns {image_id: uint8
    canvas}, train and valid."""
    rng = np.random.RandomState(seed)
    canvases, ploss = {}, {}
    os.makedirs(os.path.join(root, "mapping_dicts"), exist_ok=True)
    for split, mapping, ids in (
            ("train", "train", range(1, n_train + 1)),
            ("val", "valid", range(1001, 1001 + n_valid))):
        images, anns, cv = coco_people(rng, list(ids))
        write_keypoints_file(root, split, images, anns)
        canvases.update(cv)
        names = {"%012d" % i: "styled_%012d.jpg" % i for i in ids}
        with open(os.path.join(root, "mapping_dicts", f"{mapping}_dict_style_"
                               f"{STYLES}_alpha_{ALPHA}.json"), "w") as f:
            json.dump(names, f)
        ploss.update({n: float(v) for n, v in zip(
            names.values(), rng.uniform(0.1, 2.5, len(names)))})
    os.makedirs(dict_root, exist_ok=True)
    with open(os.path.join(dict_root, f"perceptual_loss_dict_alpha_{ALPHA}_"
                           f"styles_{STYLES}.json"), "w") as f:
        json.dump(ploss, f)
    return canvases


@contextlib.contextmanager
def engine_environment(mods, tmp):
    """The CLI's surroundings for the trainer phase: the experiments root
    and the perceptual-loss dicts in ``tmp`` (``CONFIG`` and the
    environment), ENGINE_CONFIG, no pretrained file, and f32 and no
    profiling unless a step sets them."""
    paths = mods["CONFIG"]["paths"]
    saved_paths = dict(paths)
    keys = ("STLPOSE_EXPERIMENTS_PATH", "STLPOSE_PRETRAINED",
            "STLPOSE_MODEL_CONFIG", "STLPOSE_DTYPE", "STLPOSE_PROFILE")
    saved_env = {k: os.environ.get(k) for k in keys}
    paths["experiments_path"] = os.path.join(tmp, "experiments")
    paths["dict_path"] = os.path.join(tmp, "dicts")
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(STLPOSE_EXPERIMENTS_PATH=paths["experiments_path"],
                      STLPOSE_PRETRAINED="", STLPOSE_MODEL_CONFIG=ENGINE_CONFIG)
    try:
        yield
    finally:
        paths.update(saved_paths)
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def canvases_in_memory(mods, canvases):
    """Every engine pipeline reads the decoded canvases from memory, not
    JPEG files (the card's machine has no cv2)."""
    pipe_cls = mods["PoseDataPipeline"]
    load_raw = pipe_cls._load_one_raw
    pipe_cls._load_one_raw = \
        lambda self, rec: self._letterbox(canvases[rec.image_id], rec)
    try:
        yield
    finally:
        pipe_cls._load_one_raw = load_raw


@contextlib.contextmanager
def epoch_clock(torch, trainer_cls, times):
    """Host ms of every train and valid epoch of any PoseTrainer, each
    bracketed by a synchronise, appended to ``times["train"|"valid"]``;
    and what each ``training_loop`` starts from (epoch, step, learning
    rate, scheduler), appended to ``times["start"]``."""
    saved = {n: getattr(trainer_cls, n) for n in
             ("_run_train_epoch", "_run_valid_epoch", "training_loop")}

    def timed(key, fn):
        def call(self, epoch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, epoch)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def loop(self):
        times["start"].append({
            "epoch": self.cur_epoch, "step": int(self.state.step),
            "lr": self.state.optimizer.param_groups[0]["lr"],
            "scheduler": self.scheduler.state_dict()})
        return saved["training_loop"](self)

    trainer_cls._run_train_epoch = timed("train", saved["_run_train_epoch"])
    trainer_cls._run_valid_epoch = timed("valid", saved["_run_valid_epoch"])
    trainer_cls.training_loop = loop
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(trainer_cls, n, fn)


def new_experiment(mods, name, epochs, model, device_warp=True, flags=()):
    """01_create_experiment with the CLI's flags for the trainer phase and
    ``flags``, then ``dataset.device_warp`` set as asked (True for the
    trainer phase, whose crops then need no cv2) and the seeded weights
    saved as the experiment's checkpoint "seed"."""
    exp_path = mods["scripts"]["01_create_experiment"].main(
        ["-d", name, "--dataset_name", "styled_coco", "--styles", STYLES,
         "--alpha", ALPHA, "--batch_size", str(TRAIN_B), "--num_epochs",
         str(epochs), "--save_frequency", "1"] +
        [a for k, v in AUG["dataset"].items()
         for a in (f"--{k}", str(v).lower())] + list(flags))
    exp = mods["load_experiment_parameters"](exp_path)
    exp["dataset"]["device_warp"] = device_warp
    mods["save_experiment_parameters"](exp_path, exp)
    mods["save_checkpoint"](mods["create_train_state"](model, exp),
                            exp_path, "seed")
    return exp_path


def check_logs(exp_path, epochs, label):
    """training_logs.json holds ``epochs`` finite epochs."""
    with open(os.path.join(exp_path, "training_logs.json")) as f:
        logs = json.load(f)
    vals = [v for key in ("loss", "accuracy")
            for split in ("training", "validation")
            for v in logs[key][split]]
    if len(logs["loss"]["training"]) != epochs or \
            len(vals) != 4 * epochs or not np.isfinite(vals).all():
        fail(f"{label}: training_logs.json {logs}")
    return logs


def trainer_vs_plain(torch, mods, exp_path, data, dev):
    """Two PoseTrainers from checkpoint "seed", one on the kernels and one
    on their plain versions, cuDNN deterministic: the first valid batch's
    eval step and the first train batch's step of each."""
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True):
            with (plain_versions(mods) if plain
                  else contextlib.nullcontext()):
                tr = mods["PoseTrainer"](exp_path, checkpoint="seed",
                                         data_path=data,
                                         use_perceptual_loss=True,
                                         device=dev)
                tr.load_dataset()
                tr.setup_model(config_name=ENGINE_CONFIG, pretrained=None)
                _, vm = tr.eval_step(tr.state, next(iter(tr.valid_pipe)))
                tb = next(iter(tr.train_pipe))
                m = tr.train_step(tr.state, tr._step_view(tb))
                torch.cuda.synchronize()
                runs.append(({k: tb[k] for k in ("image", "target",
                                                 "target_weight")},
                             {k: float(v) for k, v in vm.items()},
                             {k: float(v) for k, v in m.items()},
                             [p.detach().clone()
                              for p in tr.model.parameters()]))
                del tr
    finally:
        torch.backends.cudnn.deterministic = False
    (bk, vk, mk, pk), (bp, vp, mp, pp) = runs
    out = {f"{k}_max_abs_diff": float((bk[k] - bp[k]).abs().max())
           for k in bk}
    out.update(valid_kernels=vk, valid_plain=vp, step_kernels=mk,
               step_plain=mp,
               loss_rel_diff=abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
               param_max_rel_diff=max(
                   float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(pk, pp)))
    print("trainer, kernels vs plain versions:", json.dumps(out))
    # crops and targets 0.0; the step within the training path's limits;
    # the valid batch's loss and PCK equal
    if not (all(out[f"{k}_max_abs_diff"] == 0.0 for k in bk)
            and out["loss_rel_diff"] <= 1e-6
            and out["param_max_rel_diff"] <= 1e-6
            and all(mk[k] == mp[k] for k in ("pck_hit", "pck_cnt"))
            and vk == vp):
        fail(f"trainer disagrees with its plain-version run: {out}")
    return out


def engine_iteration(mods, trainer):
    """One iteration of the engine's train loop on ``trainer``: the next
    batch of its pipeline (host letterbox, collate, K4), the step (K1) and
    the device-side metric update; the pipeline restarts when it ends."""
    state = {"it": iter(trainer.train_pipe)}
    acc = mods["MetricAccumulator"]()

    def iteration():
        try:
            batch = next(state["it"])
        except StopIteration:
            state["it"] = iter(trainer.train_pipe)
            batch = next(state["it"])
        acc.update(trainer.train_step(trainer.state,
                                      trainer._step_view(batch)))

    return iteration


def trainer_path(torch, mods, dev, args, tmp, bare_ms):
    """The training CLI at full width, in-process through the scripts'
    ``main``: 01 (Styled-COCO, B = 32, 2 epochs, checkpoint every epoch,
    COCO augmentation, device warp) -> seeded HRNet-W32 weights as the
    experiment's checkpoint "seed" -> 02 from it, weights only, with the
    perceptual loss, f32 (every counter set to 0 first: K4 and K1 must
    launch, K1 through its bulk kernel; 2 finite epochs, checkpoints 0, 1
    and final, the StepTimer stats, the scheduler stepped) -> 02 resumed
    from checkpoint 1 with 3 epochs (epoch 1, step, learning rate and
    scheduler restored) -> the trainer on the kernels against the trainer
    on the plain versions -> 02 for one epoch in bf16 (f32 parameters,
    Adam moments and checkpoint) -> 03 on "final" with flip-TTA (10 finite
    stats). ``bare_ms``: ms per iteration of the training path's bare
    loop in this run. Returns (launches, summary, (canvases, {dtype:
    (trainer, ms per iteration)}))."""
    t0 = time.time()
    data = os.path.join(tmp, "data")
    canvases = engine_dataset(data, os.path.join(tmp, "dicts"),
                              args.seed + 30)
    model = seeded_weights(torch, mods["PoseHighResolutionNet"](
        mods["get_hrnet_config"](ENGINE_CONFIG), device=dev), args.seed + 7)
    scripts = mods["scripts"]
    times = {"train": [], "valid": [], "start": []}
    argv = ["--data_path", data, "--use_perceptual_loss", "true"]
    with engine_environment(mods, tmp), canvases_in_memory(mods, canvases), \
            epoch_clock(torch, mods["PoseTrainer"], times):
        exp_path = new_experiment(mods, "chip_smoke_train", 2, model)
        print(f"trainer set-up in {time.time() - t0:.1f} s", flush=True)

        reset_counts(mods)
        trainer = scripts["02_train"].main(
            ["-d", exp_path, "--checkpoint", "seed"] + argv)
        torch.cuda.synchronize()
        launches = launch_counts(mods)
        print("trainer-path launches (two epochs):", json.dumps(launches))
        if launches["warp_two_pass"] < 1 or launches["heatmap_peaks"] < 1:
            fail(f"a kernel of the trainer path was not launched: {launches}")
        k1_took_bulk(mods, "trainer")
        n_iter = len(trainer.train_pipe)
        if n_iter != ENGINE_TRAIN_IMAGES * EVAL_PEOPLE // TRAIN_B or \
                len(trainer.valid_pipe) != 5:
            fail(f"trainer: {n_iter} train and {len(trainer.valid_pipe)} "
                 f"valid batches")
        logs = check_logs(exp_path, 2, "02")
        for label in ("0", "1", "final"):
            if not os.path.exists(mods["checkpoint_path"](exp_path, label)
                                  + ".pt"):
                fail(f"02: no checkpoint {label}")
        with open(os.path.join(exp_path, "timing_logs.json")) as f:
            timing = json.load(f)["train_epoch"]
        sched = trainer.scheduler.state_dict()
        if len(timing) != 2 or not all(t["examples_per_sec"] > 0
                                       for t in timing) \
                or sched["best"] is None:
            fail(f"02: StepTimer stats {timing}, scheduler {sched}")
        end = {"epoch": 1, "step": int(trainer.state.step),
               "lr": trainer.state.optimizer.param_groups[0]["lr"],
               "scheduler": sched}

        exp = mods["load_experiment_parameters"](exp_path)
        exp["training"]["num_epochs"] = 3
        mods["save_experiment_parameters"](exp_path, exp)
        resumed = scripts["02_train"].main(
            ["-d", exp_path, "--checkpoint", "1", "--resume_training",
             "true"] + argv)
        if times["start"][-1] != end or end["step"] != 2 * n_iter:
            fail(f"resume restored {times['start'][-1]}, expected {end}")
        check_logs(exp_path, 4, "02 resumed")
        del resumed

        vs_plain = trainer_vs_plain(torch, mods, exp_path, data, dev)

        exp16 = new_experiment(mods, "chip_smoke_train_bf16", 1, model)
        os.environ["STLPOSE_DTYPE"] = "bfloat16"
        n_train = len(times["train"])
        tr16 = scripts["02_train"].main(["-d", exp16, "--checkpoint",
                                         "seed"] + argv)
        del os.environ["STLPOSE_DTYPE"]
        with open(os.path.join(exp16, "timing_logs.json")) as f:
            timing16 = json.load(f)["train_epoch"][0]
        blob = torch.load(mods["checkpoint_path"](exp16, "final") + ".pt",
                          map_location="cpu", weights_only=True)
        kinds = {"params": {p.dtype for p in tr16.model.parameters()},
                 "adam": {t.dtype for s in tr16.state.optimizer.state.values()
                          for t in s.values() if t.dim() > 0},
                 "checkpoint": {v.dtype for k, v in
                                blob["model_state_dict"].items()
                                if not k.endswith("num_batches_tracked")}}
        logs16 = check_logs(exp16, 1, "02 bf16")
        if tr16.model.dtype != torch.bfloat16 or \
                any(v != {torch.float32} for v in kinds.values()):
            fail(f"bf16 training: dtypes {kinds}")
        del blob

        stats = scripts["03_evaluate"].main(
            ["-d", exp_path, "--checkpoint", "final", "--flip", "true",
             "--data_path", data])
        stats_file = os.path.join(exp_path, f"evaluation_stats_styled_coco_"
                                  f"styles_{STYLES}_alpha_{ALPHA}.json")
        with open(stats_file) as f:
            saved = json.load(f)["final"]
        if len(saved) != 10 or not np.isfinite(list(saved.values())).all():
            fail(f"03: stats {saved}")

    train_ms = times["train"][1] / n_iter      # epoch 1: cuDNN plans made
    summary = {
        "batch": TRAIN_B, "train_batches_per_epoch": n_iter,
        "engine_ms_per_iteration": train_ms,
        "engine_steptimer_examples_per_s": timing[1]["examples_per_sec"],
        "engine_steptimer_ms_per_iteration":
            1e3 / timing[1]["steps_per_sec"],
        "bare_train_path_ms_per_iteration": bare_ms,
        "engine_over_bare": train_ms / bare_ms,
        "valid_epoch_ms": times["valid"][1],
        "train_epoch_ms": times["train"][:2],
        "launches_per_iteration": {k: v / (2 * n_iter) for k, v in
                                   launches.items() if v},
        "logs": {k: logs[k] for k in ("loss", "accuracy")},
        "resumed_from": end,
        "kernels_vs_plain": vs_plain,
        "bf16_epoch_ms": times["train"][n_train],
        "bf16_ms_per_iteration": times["train"][n_train] / n_iter,
        "bf16_steptimer_ms_per_iteration": 1e3 / timing16["steps_per_sec"],
        "bf16_loss": logs16["loss"]["training"][0],
        "stats_03": list(saved.values())}
    print("trainer:", json.dumps(summary), flush=True)
    return launches, summary, (canvases, {
        "f32": (trainer, train_ms),
        "bf16": (tr16, summary["bf16_steptimer_ms_per_iteration"])})


# --------------------------------------------------------------- style path
# Style transfer: the shapes of the three aux scripts (the preload's 512 x
# 512 canvases at its batch of 32, the perceptual loss at its batch of 64
# on 224 x 224, the decoder trainer at its batch of 8 on 256 x 256), the
# detection pipeline's 400 x 400 canvases at B = 8, and the style CLI at
# the trainer phase's width: 4 train batches of 32 (64 images, two people
# each) and one validation batch
STYLE_BANK, STYLE_ALPHA = 16, 0.8
STYLE_CROP, PRELOAD_SIDE = (256, 192), 512
PERCEPTUAL_B, PERCEPTUAL_SIDE = 64, 224
DECODER_B, DECODER_SIDE, DECODER_STEPS = 8, 256, 10
DETECTION_B, DETECTION_SIDE = 8, 400
STYLE_TRAIN_IMAGES, STYLE_VALID_IMAGES = 64, 16
# the card against the CPU on the same weights and inputs, f32 with TF32
# off: ~25 chained 3x3 convolutions summed in other orders (two CPU
# libraries differ by 1e-5 on [0, 1] images:
# tests/test_torch_style_transfer.py)
STYLE_CPU_TOL, LOSS_CPU_REL_TOL = 2e-4, 1e-4
# alpha 0 against alpha 1 on ``style_weights`` and the tinted bank: ~0.19
# apart at most at 256 x 192 and at 512 x 512 on the CPU (B = 2); a
# quarter of that is the floor
STYLE_ALPHA_FLOOR = 0.05


def style_bank(seed, hw):
    """STYLE_BANK seeded exemplars of (H, W) = hw in [0, 1] (what
    ``read_style_bank`` reads from a folder of images), each with a tint
    and a contrast of its own: AdaIN moves content towards moments that
    differ from uniform noise's."""
    rng = np.random.RandomState(seed + hw[0] * 7 + hw[1])
    tint = rng.uniform(0.1, 0.9, (STYLE_BANK, 1, 1, 3))
    contrast = rng.uniform(0.05, 0.5, (STYLE_BANK, 1, 1, 1))
    noise = rng.rand(STYLE_BANK, hw[0], hw[1], 3) - 0.5
    return np.clip(tint + contrast * noise, 0.0, 1.0).astype(np.float32)


def style_weights(seed, n_convs=10):
    """Seeded VGG16 (convs 0..n_convs - 1, He-scaled) and AdaIN decoder
    (variance 1/fan_in) weights in the JAX package's Flax layout (HWIO
    kernels, biases of std 0.05), made with numpy. The default init's
    stylizer makes images of std 0.03 that alpha barely moves; these make
    alpha 0 and 1 differ by ~0.2 on the tinted bank."""
    from stlpose_tpu_torch.models.adain import AdaINDecoder
    from stlpose_tpu_torch.models.vgg import VGG16_CHANNELS
    rng = np.random.RandomState(seed)

    def conv(cin, cout, gain):
        return {"kernel": (rng.randn(3, 3, cin, cout) *
                           np.sqrt(gain / (9 * cin))).astype(np.float32),
                "bias": (rng.randn(cout) * 0.05).astype(np.float32)}

    enc, cin = {}, 3
    for i in range(n_convs):
        enc[f"conv{i}"] = conv(cin, VGG16_CHANNELS[i], 2.0)
        cin = VGG16_CHANNELS[i]
    dec = {f"dec{i}": conv(cin, cout, 1.0)
           for i, (cin, cout) in enumerate(AdaINDecoder._CHANNELS)}
    return enc, dec


def seeded_stylizer(mods, dev, enc, dec):
    """``AdaINStylizer`` on ``dev`` holding ``style_weights``' encoder (to
    relu3_3) and decoder, through the port's converters."""
    taps = mods["AdaINStylizer"].ENC_TAPS
    convert = mods["convert"]
    return mods["AdaINStylizer"](
        convert.vgg_from_jax({"params": {f"conv{i}": enc[f"conv{i}"]
                                         for i in range(max(taps) + 1)}},
                             taps, dev),
        convert.adain_decoder_from_jax({"params": dec}, dev), device=dev)


@contextlib.contextmanager
def style_bank_in_memory(mods, seed):
    """``build_inline_stylizer`` reads ``style_bank`` (the card's machine
    has no cv2 to read exemplar files)."""
    adain = mods["adain"]
    saved = adain.read_style_bank
    adain.read_style_bank = lambda style_dir, crop_hw: style_bank(seed,
                                                                   crop_hw)
    try:
        yield
    finally:
        adain.read_style_bank = saved


@contextlib.contextmanager
def crops_in_memory(mods):
    """Every host-warp PoseDataPipeline takes seeded 256 x 192 crops in
    place of ``process_sample``'s (cv2.warpAffine): integer-valued f32
    pixels, joints inside the crop where visible, and the record's
    metadata."""
    cls = mods["PoseDataPipeline"]
    saved = cls._load_one

    def load(self, rec):
        rng = np.random.RandomState([int(rec.image_id),
                                     int(rec.center[0] * 16) % 2 ** 31])
        h, w = STYLE_CROP
        vis = rec.joints_vis.astype(np.float32)
        joints = (np.stack([rng.uniform(0, w - 1, len(vis)),
                            rng.uniform(0, h - 1, len(vis))], -1)
                  * (vis[:, None] > 0)).astype(np.float32)
        meta = {"center": rec.center.astype(np.float32),
                "scale": rec.scale.astype(np.float32),
                "rotation": np.float32(0.0), "score": np.float32(rec.score),
                "image_id": np.int64(rec.image_id),
                "perceptual_loss": np.float32(rec.perceptual_loss)}
        return (rng.randint(0, 256, (h, w, 3)).astype(np.float32), joints,
                vis, meta)

    cls._load_one = load
    try:
        yield
    finally:
        cls._load_one = saved


@contextlib.contextmanager
def detection_canvases_in_memory(mods, canvases):
    """Every DetectionDataPipeline letterboxes the decoded square images
    ``canvases`` ({image_id: uint8}) from memory (nearest resize; no cv2),
    boxes scaled and padded as ``_load_one`` does."""
    cls = mods["DetectionDataPipeline"]
    saved = cls._load_one

    def load(self, rec):
        img = canvases[rec.image_id]
        S = self.img_size
        scale = S / max(img.shape[:2])
        idx = np.minimum((np.arange(S) / scale).astype(np.int64),
                         img.shape[0] - 1)
        k = min(len(rec.boxes), self.max_boxes)
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros((self.max_boxes,), np.int32)
        mask = np.zeros((self.max_boxes,), np.float32)
        boxes[:k] = rec.boxes[:k] * scale
        labels[:k] = rec.labels[:k]
        mask[:k] = 1.0
        return (img[idx][:, idx].astype(np.float32) / np.float32(255.0),
                boxes, labels, mask, np.float32(scale),
                np.int64(rec.image_id), np.float32(rec.perceptual_loss))

    cls._load_one = load
    try:
        yield
    finally:
        cls._load_one = saved


@contextlib.contextmanager
def stylizer_clock(torch, cls, times):
    """CUDA-event ms of every call of any ``cls`` (the stylizer), input
    conversion included, appended to ``times``."""
    saved = cls.__call__

    def timed(self, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = saved(self, *a, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        return out

    cls.__call__ = timed
    try:
        yield
    finally:
        cls.__call__ = saved


def on_cpu(torch, mods, stylizer):
    """The same stylizer weights on the CPU."""
    import copy
    return mods["AdaINStylizer"](copy.deepcopy(stylizer.encoder).cpu(),
                                 copy.deepcopy(stylizer.decoder).cpu(),
                                 device="cpu")


def check_stylizer(torch, mods, dev, seed):
    """The stylizer on ``style_weights`` at B = TRAIN_B on 256 x 192
    crops from the bank with alpha STYLE_ALPHA and with a per-sample alpha
    vector, then on the preload's PRELOAD_SIDE canvases: finite, in
    [0, 1], alpha 0 more than STYLE_ALPHA_FLOOR from alpha 1 somewhere, a
    second call equal; the same weights on the CPU at B = 2 within
    STYLE_CPU_TOL; CUDA-event ms, at the crops also with cuDNN's benchmark
    mode (its own algorithm search) in place of its heuristics.
    Returns (summary, stylizer, the timed call at the crops' shape)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    stylizer = seeded_stylizer(mods, dev, *style_weights(seed))
    out = {}
    for label, (h, w) in (("crops", STYLE_CROP),
                          ("preload", (PRELOAD_SIDE, PRELOAD_SIDE))):
        content = torch.rand((TRAIN_B, h, w, 3), generator=g).to(dev)
        bank = torch.from_numpy(style_bank(seed, (h, w))).to(dev)
        style = bank[torch.randint(0, STYLE_BANK, (TRAIN_B,),
                                   generator=g).to(dev)]
        alphas = {"scalar": STYLE_ALPHA,
                  "vector": torch.rand(TRAIN_B, generator=g).to(dev),
                  "zero": 0.0, "one": 1.0}
        res = {k: stylizer(content, style, a) for k, a in alphas.items()}
        again = stylizer(content, style, STYLE_ALPHA)
        torch.cuda.synchronize()
        for k, y in res.items():
            if tuple(y.shape) != (TRAIN_B, h, w, 3) or \
                    not bool(torch.isfinite(y).all()) or \
                    float(y.min()) < 0.0 or float(y.max()) > 1.0:
                fail(f"stylizer ({label}, alpha {k}): shape "
                     f"{tuple(y.shape)} or values outside [0, 1]")

        def call(content=content, style=style):
            return stylizer(content, style, STYLE_ALPHA)

        rec = {"alpha0_vs_alpha1_max_abs": float(
                   (res["zero"] - res["one"]).abs().max()),
               "repeat_equal": bool(torch.equal(again, res["scalar"])),
               "ms": elapsed_ms(torch, call, 5),
               "output_std": float(res["scalar"].std())}
        if rec["alpha0_vs_alpha1_max_abs"] <= STYLE_ALPHA_FLOOR or \
                not rec["repeat_equal"]:
            fail(f"stylizer ({label}): {rec}")
        if label == "crops":
            ref = on_cpu(torch, mods, stylizer)(
                content[:2].cpu(), style[:2].cpu(),
                alphas["vector"][:2].cpu())
            rec["cpu_max_abs_err"] = float(
                (res["vector"][:2].cpu() - ref).abs().max())
            if not rec["cpu_max_abs_err"] <= STYLE_CPU_TOL:
                fail(f"stylizer: card vs CPU {rec['cpu_max_abs_err']} > "
                     f"{STYLE_CPU_TOL}")
            torch.backends.cudnn.benchmark = True
            try:
                rec["ms_cudnn_benchmark"] = elapsed_ms(torch, call, 5)
            finally:
                torch.backends.cudnn.benchmark = False
            crops_call = (call, rec["ms"])
        out[label] = rec
    return out, stylizer, crops_call


def check_perceptual(torch, mods, dev, seed):
    """The perceptual loss (VGG16 to relu4_3) at B = PERCEPTUAL_B on
    224 x 224, as the offline script calls it: identical inputs give 0, a
    small corruption scores below a large one, the CPU agrees at B = 2
    within LOSS_CPU_REL_TOL; CUDA-event ms."""
    import copy
    g = torch.Generator(device="cpu").manual_seed(seed)
    vgg_mod = mods["vgg"]
    vgg = vgg_mod.VGG16Features(device=dev, generator=g)
    fn = vgg_mod.make_perceptual_loss_fn(vgg)
    s = PERCEPTUAL_SIDE
    x = torch.rand((PERCEPTUAL_B, s, s, 3), generator=g)
    noise = torch.rand((PERCEPTUAL_B, s, s, 3), generator=g) - 0.5
    x, noise = x.to(dev), noise.to(dev)
    small = (x + 0.02 * noise).clamp(0, 1)
    large = (x + 0.4 * noise).clamp(0, 1)
    with torch.no_grad():
        same = fn(x, x)
        l_small, l_large = fn(x, small), fn(x, large)
        ms = elapsed_ms(torch, lambda: fn(x, small), 5)
        ref = vgg_mod.make_perceptual_loss_fn(copy.deepcopy(vgg).cpu())(
            x[:2].cpu(), large[:2].cpu())
    rec = {"identical_max": float(same.abs().max()),
           "small_mean": float(l_small.mean()),
           "large_mean": float(l_large.mean()),
           "cpu_max_rel_err": float(((l_large[:2].cpu() - ref).abs() /
                                     ref.abs()).max()),
           "ms": ms}
    if tuple(same.shape) != (PERCEPTUAL_B,) or rec["identical_max"] != 0.0 \
            or not bool((l_small < l_large).all()) or \
            not rec["cpu_max_rel_err"] <= LOSS_CPU_REL_TOL:
        fail(f"perceptual loss: {rec}")
    return rec


def check_decoder_training(torch, mods, stylizer, seed):
    """``train_adain_decoder`` at B = DECODER_B on DECODER_SIDE squares,
    recon_weight 1, DECODER_STEPS steps on one seeded batch: the loss
    falls; host ms per step after the first (each step fetches its
    loss)."""
    import copy
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = DECODER_SIDE
    batch = (torch.rand((DECODER_B, s, s, 3), generator=g),
             torch.rand((DECODER_B, s, s, 3), generator=g))
    stamps = []
    decoder = copy.deepcopy(stylizer.decoder)
    _, hist = mods["adain"].train_adain_decoder(
        stylizer.encoder, decoder, [batch] * DECODER_STEPS,
        recon_weight=1.0, callback=lambda i, loss: stamps.append(
            time.perf_counter()))
    rec = {"loss": hist, "ms_per_step": (stamps[-1] - stamps[0]) * 1e3 /
           (len(stamps) - 1)}
    if len(hist) != DECODER_STEPS or not np.isfinite(hist).all() or \
            not np.mean(hist[-3:]) < np.mean(hist[:3]):
        fail(f"decoder training: loss {hist}")
    return rec


def check_detection_stylizer(torch, mods, dev, tmp, seed):
    """``get_detection_dataset`` on a seeded COCO file of DETECTION_B
    640 x 640 images (two people each) at DETECTION_SIDE, without and
    with ``dataset.inline_style``: the stylized canvases differ, in
    [0, 1]; boxes, labels and masks equal the unstylized batch's;
    CUDA-event ms of the stylizer at that shape."""
    data = os.path.join(tmp, "detection")
    rng = np.random.RandomState(seed)
    images, anns, canvases = coco_people(rng, list(range(1,
                                                         DETECTION_B + 1)))
    write_keypoints_file(data, "train", images, anns)
    exp = mods["default_experiment_args"]()
    exp["dataset"]["image_size"] = DETECTION_SIDE
    exp["training"]["batch_size"] = DETECTION_B
    with detection_canvases_in_memory(mods, canvases), \
            style_bank_in_memory(mods, seed):
        plain = mods["get_detection_dataset"](exp, "train", data_path=data,
                                              num_workers=4, device=dev)
        exp["dataset"]["inline_style"] = {"style_dir": os.path.join(
            tmp, "styles"), "alpha": STYLE_ALPHA}
        styled = mods["get_detection_dataset"](exp, "train", data_path=data,
                                               num_workers=4, device=dev)
        p, b = next(iter(plain)), next(iter(styled))
    img = b["image"]
    torch.cuda.synchronize()
    rec = {"boxes_per_image": float(b["box_mask"].sum(1).mean()),
           "mean_abs_change": float((img.cpu() - torch.from_numpy(
               p["image"])).abs().mean())}
    held = {
        "a tensor on the device": torch.is_tensor(img) and
        img.device.type == dev.type,
        "the shape": tuple(img.shape) == (DETECTION_B, DETECTION_SIDE,
                                          DETECTION_SIDE, 3),
        "finite, in [0, 1]": bool(torch.isfinite(img).all()) and
        float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
        "changed": rec["mean_abs_change"] > 1e-3,
        **{f"{k} equal": np.array_equal(b[k], p[k])
           for k in ("boxes", "labels", "box_mask", "scale")},
        "boxes": rec["boxes_per_image"] >= 1}
    if not all(held.values()):
        fail(f"detection stylizer: {rec}, not held: "
             f"{[k for k, v in held.items() if not v]}")
    bank = styled.style_bank
    idx = torch.arange(DETECTION_B, device=dev) % STYLE_BANK
    content = torch.from_numpy(p["image"]).to(dev)
    rec["ms"] = elapsed_ms(torch, lambda: styled.stylizer(
        content, bank[idx], STYLE_ALPHA), 5)
    return rec


# the aux_* scripts' main: 64 COCO-sized images (the preload's two
# batches of 32, the perceptual script's one batch of 64)
AUX_IMAGES, AUX_HW = 64, (480, 640)


def nearest(img, hw):
    """``img`` (H, W, ...) resized to (H', W') = hw by nearest index."""
    ys = np.arange(hw[0]) * img.shape[0] // hw[0]
    xs = np.arange(hw[1]) * img.shape[1] // hw[1]
    return img[ys][:, xs]


@contextlib.contextmanager
def aux_images_in_memory(mods, seed, written):
    """The aux_* scripts read and write their images in memory in place of
    cv2's files (the card's machine has no cv2): a path that the preload
    wrote reads back what it wrote (``written``, {path: uint8}; an empty
    file marks it on disk), any other a seeded AUX_HW uint8 image; resizes
    by nearest index."""
    import zlib
    sc = mods["scripts"]
    pre, perc, dec = (sc["aux_styled_coco_preload"],
                      sc["aux_create_offline_perceptual_loss"],
                      sc["aux_train_adain_decoder"])

    def image(path):
        if path in written:
            return written[path]
        rng = np.random.RandomState([seed, zlib.crc32(path.encode())])
        return rng.randint(0, 256, AUX_HW + (3,)).astype(np.uint8)

    def read_square(path, size):
        img = image(path)
        return (nearest(img, (size, size)).astype(np.float32) / 255.0,
                img.shape[:2])

    def write_resized(path, img, hw):
        written[path] = (nearest(img, hw) * 255).astype(np.uint8)
        open(path, "wb").close()

    def read_short_side(path, size):
        img = image(path)
        scale = max(size / img.shape[0], size / img.shape[1])
        return nearest(img, (max(size, int(round(img.shape[0] * scale))),
                             max(size, int(round(img.shape[1] * scale)))))

    replaced = [(pre, "read_square", read_square),
                (pre, "write_resized", write_resized),
                (perc, "read_image", lambda path, size=224: nearest(
                    image(path), (size, size)).astype(np.float32) / 255.0),
                (dec, "read_short_side", read_short_side)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in replaced]
    for m, name, fn in replaced:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def aux_scripts_path(torch, mods, dev, tmp, seed):
    """The three aux_* scripts' ``main`` on ``dev``, chained as a user runs
    them, their images from ``aux_images_in_memory`` and the exemplars
    from ``style_bank_in_memory``: the decoder trainer (B = DECODER_B at
    DECODER_SIDE, DECODER_STEPS steps, the encoder from a torchvision
    .pth of ``style_weights``) writes its npz; the preload stylizes
    AUX_IMAGES images at PRELOAD_SIDE in batches of TRAIN_B with random
    alphas, the trained decoder and that .pth, and writes its JPEGs and
    mapping; the offline perceptual script scores them at B =
    PERCEPTUAL_B. Checks: finite losses, the npz loads, every image
    mapped, written at its own size and scored finite and above 0.
    Host seconds of each ``main``."""
    sc = mods["scripts"]
    root = os.path.join(tmp, "aux")
    data = os.path.join(root, "data")
    orig = os.path.join(data, "original_images", "train2017")
    styles = os.path.join(root, "styles")
    for d, names in ((orig, ["%012d.jpg" % i for i in range(AUX_IMAGES)]),
                     (styles, [f"style{i}.jpg" for i in range(STYLE_BANK)])):
        os.makedirs(d)
        for n in names:
            open(os.path.join(d, n), "wb").close()
    enc, _ = style_weights(seed)
    conv_idx = mods["vgg"].VGG16_CONV_IDX
    pth = os.path.join(root, "vgg16.pth")
    torch.save({f"features.{conv_idx[int(k[4:])]}.{leaf}": torch.from_numpy(
        np.ascontiguousarray(v["kernel"].transpose(3, 2, 0, 1))
        if leaf == "weight" else v["bias"])
        for k, v in enc.items() for leaf in ("weight", "bias")}, pth)
    npz = os.path.join(root, "decoder.npz")
    written, secs = {}, {}
    with aux_images_in_memory(mods, seed, written), \
            style_bank_in_memory(mods, seed):
        t = time.perf_counter()
        hist = sc["aux_train_adain_decoder"].main(
            ["--content_dir", orig, "--style_dir", styles, "--out", npz,
             "--steps", str(DECODER_STEPS), "--batch_size", str(DECODER_B),
             "--size", str(DECODER_SIDE), "--vgg_weights", pth,
             "--log_every", str(DECODER_STEPS), "--seed", str(seed),
             "--device", dev.type])
        secs["train_adain_decoder"] = time.perf_counter() - t
        t = time.perf_counter()
        mapping_file = sc["aux_styled_coco_preload"].main(
            ["--style_dir", styles, "--alpha", "random", "--data_path", data,
             "--batch_size", str(TRAIN_B), "--size", str(PRELOAD_SIDE),
             "--decoder_ckpt", npz, "--vgg_weights", pth,
             "--device", dev.type])
        secs["styled_coco_preload"] = time.perf_counter() - t
        t = time.perf_counter()
        losses_file = sc["aux_create_offline_perceptual_loss"].main(
            ["--alpha", "random", "--data_path", data, "--dict_path",
             os.path.join(root, "dicts"), "--batch_size", str(PERCEPTUAL_B),
             "--vgg_weights", pth, "--device", dev.type])
        secs["create_offline_perceptual_loss"] = time.perf_counter() - t
    with open(mapping_file) as f:
        mapping = json.load(f)
    with open(losses_file) as f:
        losses = json.load(f)
    decoder = mods["adain"].load_decoder_npz(npz, dev)
    rec = {"decoder_loss": hist, "main_s": secs,
           "alphas": len({v.split("_alpha_")[1] for v in mapping.values()}),
           "perceptual_loss": [min(losses.values(), default=None),
                               max(losses.values(), default=None)]}
    held = {
        "decoder losses finite": len(hist) == DECODER_STEPS and
        bool(np.isfinite(hist).all()),
        "decoder npz finite": all(bool(torch.isfinite(p).all())
                                  for p in decoder.parameters()),
        "every image mapped": len(mapping) == AUX_IMAGES == len(written),
        "written at its size": all(v.shape == AUX_HW + (3,)
                                   for v in written.values()),
        "random alphas": rec["alphas"] > 1,
        "every image scored": sorted(losses) == sorted(mapping.values()),
        "losses finite, above 0": all(np.isfinite(v) and v > 0
                                      for v in losses.values())}
    if not all(held.values()):
        fail(f"aux scripts: {rec}, not held: "
             f"{[k for k, v in held.items() if not v]}")
    return rec


def style_path(torch, mods, dev, args, tmp):
    """Style transfer on the card: the stylizer, the perceptual loss, the
    decoder trainer and the detection pipeline's stylizer at their
    scripts' shapes; then the style CLI at full width, in-process: 01
    with ``--inline_style_dir`` and ``--inline_style_alpha`` (Styled-COCO,
    B = 32, one epoch, host warp, the COCO augmentation flags) -> seeded
    HRNet-W32 as checkpoint "seed" -> 02 from it with the perceptual loss
    (every counter set to 0 first; the crops from ``crops_in_memory``, the
    exemplars from ``style_bank_in_memory``: K1 must launch, K4 must not;
    the train pipeline stylized, validation not; one finite epoch) -> 03
    on "final" (10 finite stats); then the engine's iteration split into
    collate (the stylizer inside it) and step, each synchronised, the
    stylizer's ms per batch, and the engine's iteration unsynchronised
    (CUDA events over an epoch's last n_iter - 1), which the stylizer's
    share is taken against. Before the CLI, the three aux_* scripts'
    ``main`` (``aux_scripts_path``). Returns (launches, summary,
    (trainer, its ms per iteration, (the stylizer's call at the crops'
    shape, its ms)))."""
    t0 = time.time()
    summary = {}
    summary["stylizer"], stylizer, crops_call = check_stylizer(
        torch, mods, dev, args.seed + 40)
    print("style, stylizer:", json.dumps(summary["stylizer"]), flush=True)
    summary["perceptual_loss"] = check_perceptual(torch, mods, dev,
                                                  args.seed + 41)
    print("style, perceptual loss:", json.dumps(summary["perceptual_loss"]),
          flush=True)
    summary["decoder_training"] = check_decoder_training(torch, mods,
                                                         stylizer,
                                                         args.seed + 42)
    print("style, decoder training:",
          json.dumps(summary["decoder_training"]), flush=True)
    summary["detection"] = check_detection_stylizer(torch, mods, dev, tmp,
                                                    args.seed + 43)
    print("style, detection stylizer:", json.dumps(summary["detection"]),
          flush=True)
    del stylizer
    summary["aux_scripts"] = aux_scripts_path(torch, mods, dev, tmp,
                                              args.seed + 47)
    print("style, aux scripts:", json.dumps(summary["aux_scripts"]),
          flush=True)

    data = os.path.join(tmp, "data")
    engine_dataset(data, os.path.join(tmp, "dicts"), args.seed + 44,
                   STYLE_TRAIN_IMAGES, STYLE_VALID_IMAGES)
    model = seeded_weights(torch, mods["PoseHighResolutionNet"](
        mods["get_hrnet_config"](ENGINE_CONFIG), device=dev), args.seed + 45)
    scripts = mods["scripts"]
    times = {"train": [], "valid": [], "start": []}
    styl_ms = []
    with engine_environment(mods, tmp), crops_in_memory(mods), \
            style_bank_in_memory(mods, args.seed + 46), \
            epoch_clock(torch, mods["PoseTrainer"], times), \
            stylizer_clock(torch, mods["AdaINStylizer"], styl_ms):
        exp_path = new_experiment(
            mods, "chip_smoke_style", 1, model, device_warp=False,
            flags=["--inline_style_dir", os.path.join(tmp, "styles"),
                   "--inline_style_alpha", str(STYLE_ALPHA)])
        print(f"style CLI set-up in {time.time() - t0:.1f} s", flush=True)
        reset_counts(mods)
        trainer = scripts["02_train"].main(
            ["-d", exp_path, "--checkpoint", "seed", "--data_path", data,
             "--use_perceptual_loss", "true"])
        torch.cuda.synchronize()
        n_iter = len(trainer.train_pipe)
        train_calls = len(styl_ms)
        tp, vp = trainer.train_pipe, trainer.valid_pipe
        if tp.device_warp or tp.stylizer is None or vp.stylizer is not None \
                or tp.style_alpha != STYLE_ALPHA or tuple(
                    tp.style_bank.shape) != (STYLE_BANK,) + STYLE_CROP + (3,) \
                or n_iter != STYLE_TRAIN_IMAGES * EVAL_PEOPLE // TRAIN_B \
                or train_calls != n_iter:
            fail(f"style CLI: {n_iter} train batches, {train_calls} "
                 f"stylizer calls, pipelines {tp.device_warp}, "
                 f"{tp.stylizer}, {vp.stylizer}")
        logs = check_logs(exp_path, 1, "02 (inline style)")
        stats = scripts["03_evaluate"].main(
            ["-d", exp_path, "--checkpoint", "final", "--data_path", data])
        torch.cuda.synchronize()
        launches = launch_counts(mods)
        print("style-path launches (01 -> 02 -> 03):", json.dumps(launches))
        if launches["heatmap_peaks"] < 1 or launches["warp_two_pass"] != 0:
            fail(f"style path: K1 must launch and K4 must not: {launches}")
        stats_file = os.path.join(exp_path, f"evaluation_stats_styled_coco_"
                                  f"styles_{STYLES}_alpha_{ALPHA}.json")
        with open(stats_file) as f:
            saved = json.load(f)["final"]
        if len(saved) != 10 or not np.isfinite(list(saved.values())).all():
            fail(f"03 (inline style): stats {saved}")

        # the engine's iteration, split: collate (host crops, upload, the
        # stylizer, finalize) and the train step, each synchronised (a
        # breakdown only: the syncs keep the host from queuing ahead)
        split = {"collate": [], "step": []}
        it = iter(tp)
        del styl_ms[:]
        for _ in range(n_iter):
            t_a = time.perf_counter()
            batch = next(it)
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            trainer.train_step(trainer.state, trainer._step_view(batch))
            torch.cuda.synchronize()
            split["collate"].append((t_b - t_a) * 1e3)
            split["step"].append((time.perf_counter() - t_b) * 1e3)
    # the engine's iteration as it runs: the epoch's last n_iter - 1
    # iterations back to back (the first, which starts the pipeline, is
    # the warm-up), no sync between them and no stylizer clock
    with crops_in_memory(mods):
        it_ms = elapsed_ms(torch, engine_iteration(mods, trainer),
                           n_iter - 1)
    styl = float(np.median(styl_ms))
    summary["cli"] = {
        "batch": TRAIN_B, "train_batches": n_iter,
        "train_epoch_ms": times["train"][0],
        "engine_ms_per_iteration": times["train"][0] / n_iter,
        "valid_epoch_ms": times["valid"][0],
        "ms_per_iteration": it_ms,
        "split_ms_synced": {k: float(np.median(v))
                            for k, v in split.items()},
        "stylizer_ms_per_batch": styl,
        "stylizer_share_of_iteration": styl / it_ms,
        "loss": logs["loss"], "accuracy": logs["accuracy"],
        "stats_03": list(saved.values())}
    print("style:", json.dumps(summary), flush=True)
    del tp, vp, it
    return launches, summary, (trainer, it_ms, crops_call)


# ------------------------------------------------- detector training (5e)
# Detector training at full width: FasterRCNNConfig() (ResNet-50-FPN,
# C = 256, 400x400; train budgets pre 1000 / post 512 proposals, 256 RPN
# anchors and 256 RoIs an image), B = 8, f32 with TF32 off, seeded
# weights; the detector CLI on 32 train and 16 valid seeded canvases with
# 1-4 people each (4 train and 2 valid batches an epoch)
DET_B, DET_SIDE, DET_LR = 8, 400, 1e-4
DET_TRAIN_IMAGES, DET_VALID_IMAGES = 32, 16
DET_CONFIG = "faster_rcnn"          # the CLI's STLPOSE_DETECTOR_CONFIG
# K3b against its plain version: autograd's scatter sums each pixel's
# contributions in another order than the kernel's fixed one
K3B_REL_TOL = 1e-5                  # of the plain gradient maps' max abs
# the train step on the kernels against the plain versions (same weights,
# draws, cuDNN deterministic): only the plain scatter's order differs
STEP_LOSS_REL_TOL, STEP_GRAD_TOL = 1e-5, 1e-4   # grads: of each max abs
# the torchvision-parity training budget's proposal NMS: per level the top
# 2000 of 30,000 / 7,500 / 1,875 / 507 / 147 anchors, 2000 picks
PARITY_LEVELS, PARITY_KEEP = (2000, 2000, 1875, 507, 147), 2000


def roi_backward_scene(torch, roi_ops, dev, rng, C=ROI_C):
    """K3b's planted case beside ``roi_scene``: two images of the serving
    levels with, each, boxes on every level, past every border (samples
    inside and outside [-1, size]), under one P2 pixel, tall and wide, in
    the last pixel's corner, and one on no level."""
    feats = [torch.randn((2, s, s, C), generator=rng, device=dev)
             for s in ROI_SIZES]
    planted = torch.tensor([
        [100.0, 100.0, 102.5, 103.0],       # under one P2 pixel
        [30.0, 5.0, 50.0, 390.0],           # tall
        [3.0, 150.0, 397.0, 175.0],         # wide
        [-15.0, -12.0, 60.0, 50.0],         # past the top-left border
        [330.0, 350.0, 440.0, 430.0],       # past the bottom-right border
        [-150.0, 50.0, 40.0, 150.0],        # far past the left border, P3
        [60.0, 60.0, 300.0, 260.0],         # P3
        [-20.0, -20.0, 300.0, 330.0],       # P4, past two borders
        [-300.0, -250.0, 700.0, 650.0],     # P5, past every border
        [396.0, 396.0, 404.0, 407.0],       # in the last pixel's corner
        [10.0, 10.0, 40.0, 40.0]], device=dev)   # on no level
    boxes = planted[None].repeat(2, 1, 1)
    levels = roi_ops._assign_levels(boxes, 4)
    levels[:, -1] = -1
    if set(levels.unique().tolist()) != {-1, 0, 1, 2, 3}:
        fail(f"K3b planted scene: levels {levels.tolist()}")
    return feats, boxes, levels


def inside_samples(torch, boxes, levels, sizes, strides=ROI_STRIDES):
    """Bilinear samples of the boxes that lie inside their level (within
    [-1, size] on both axes), as K3 and K3b take them."""
    n, sr = 7, 2
    s = torch.arange(n * sr, device=boxes.device)
    pos = (s // sr).float() + ((s % sr).float() + 0.5) / sr
    total = 0
    for li, (size, st) in enumerate(zip(sizes, strides)):
        b = boxes[levels == li] * (1.0 / st)

        def axis(lo, hi):
            g = lo[:, None] + pos[None] * (torch.clamp(hi - lo, min=1.0) /
                                           n)[:, None]
            return ((g >= -1.0) & (g <= size)).sum(1)

        total += int((axis(b[:, 0], b[:, 2]) * axis(b[:, 1], b[:, 3])).sum())
    return total


def check_roi_backward(torch, k3, roi_ops, scene, odd, dev, rng):
    """K3b against its plain version (the autograd of ``roi_align_plain``)
    at the training shape (``roi_scene``: B = 8, 256 boxes an image,
    C = 256, on a seeded upstream gradient), on the planted
    ``roi_backward_scene`` and on ``odd_roi_scene`` (C = 36): within
    K3B_REL_TOL of the plain maps' max abs; every level of the planted
    scene reached; each case run twice, the two runs equal bit for bit
    (the kernel sums in a fixed order). Timed warm and cold at the
    training shape."""
    planted = roi_backward_scene(torch, roi_ops, dev, rng)
    errs, rel, rerun = {}, {}, {}
    for case, (feats, boxes, levels) in (("planted", planted),
                                         ("odd_c_elongated", odd),
                                         ("training", scene)):
        shapes = [tuple(f.shape) for f in feats]
        g = torch.randn((*boxes.shape[:2], 7, 7, shapes[0][-1]),
                        generator=rng, device=dev)
        args = (g, shapes, boxes, levels, ROI_STRIDES)
        got = k3.roi_align_backward(*args)
        again = k3.roi_align_backward(*args)
        ref = k3.roi_align_backward_plain(*args)
        scale = max(float(r.abs().max()) for r in ref)
        errs[case] = max(float((a - r).abs().max())
                         for a, r in zip(got, ref))
        rel[case] = errs[case] / scale
        rerun[case] = max(float((a - b).abs().max())
                          for a, b in zip(got, again))
        if case == "planted" and not all(bool(r.any()) for r in ref):
            fail("K3b planted scene: a level got no gradient")
    if not max(rel.values()) <= K3B_REL_TOL:
        fail(f"K3b differs from its plain version: {rel} of the maps' max "
             f"abs (tolerance {K3B_REL_TOL})")
    if any(rerun.values()):
        fail(f"K3b differs from itself run to run: {rerun}")
    feats, boxes, levels = scene
    n_bytes = (g.numel() + sum(f.numel() for f in feats) + boxes.numel() +
               levels.numel()) * 4
    # per inside sample and channel: the 0.25 scale, 4 weight products
    # and 4 adds (the weights themselves, per sample, are not counted)
    n_in = inside_samples(torch, boxes, levels, ROI_SIZES)
    b, by = bound_ms(n_bytes, flops=9.0 * n_in * ROI_C)
    fns = {"": lambda: k3.roi_align_backward(*args),
           "plain_": lambda: k3.roi_align_backward_plain(*args),
           "library_": None}
    rec = dict(name="roi_align_backward", route="cuda",
               source="stlpose_tpu_torch/kernels/csrc/roi_align_backward.cu",
               replaces="stlpose_tpu/ops/roi_align.py:143 (no Pallas "
                        "original: the VJP of multilevel_roi_align, "
                        "differentiated at stlpose_tpu/models/"
                        "faster_rcnn.py:515-517)",
               max_abs_err=errs["training"],
               tolerance=K3B_REL_TOL * errs["training"] / rel["training"]
               if rel["training"] else 0.0,
               rel_tolerance=K3B_REL_TOL, case_errs=errs, case_rel_errs=rel,
               run_to_run_max_abs=rerun, bound_ms=b, bound_by=by,
               bytes=n_bytes, inside_samples=n_in,
               products=4 * n_in * ROI_C,
               library="none (torchvision is not on the card's machine)",
               shape=[B, ROI_P, ROI_C, *ROI_SIZES],
               **event_times(torch, fns, cold=True))
    print("K3b run-to-run max abs difference:", json.dumps(rerun),
          flush=True)
    return rec, fns


def check_nms_parity(torch, k5, dev, seed):
    """K5 at the torchvision-parity training budget (M = 6,529 candidates,
    2000 picks) on ``nms_scene``, f32 scores with ``valid`` and bf16
    scores without: keep masks equal to the plain loop's, the planted
    cases as greedy NMS gives them; CUDA-event ms warm and cold (L2
    flushed), beside the pick-argmax latency floor and the design's."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    boxes, scores, valid = nms_scene(torch, dev, g, PARITY_LEVELS)
    errs = {}
    for label, sc, v in (("f32_valid", scores, valid),
                         ("bf16_no_valid", scores.to(torch.bfloat16), None)):
        got = k5.box_nms_topk(boxes, sc, 0.7, v, PARITY_KEEP)
        ref = k5.box_nms_topk_plain(boxes, sc, 0.7, v, PARITY_KEEP)
        errs[label] = int((got != ref).sum())
        if errs[label]:
            fail(f"K5 at M = {boxes.shape[1]} ({label}): keep mask differs "
                 f"from the plain version at {errs[label]} candidates")
    keep = k5.box_nms_topk(boxes, scores, 0.7, valid, PARITY_KEEP)
    picks = keep.sum(1)
    if not (bool(keep[0, 10]) and not bool(keep[0, 11:14].any())
            and bool(keep[0, 20:24].all()) and int(picks[1]) == 0
            and int(picks[2]) == 0 and 0 < int(picks[3]) <= 10):
        fail(f"K5 at M = {boxes.shape[1]}: planted cases wrong (picks "
             f"{picks.tolist()})")
    rounds = {t: argmax_round_ms(torch, dev, t) for t in (256, 1024)}
    floor, chunks = nms_design_floor(torch, boxes, scores, valid, keep,
                                     PARITY_KEEP, rounds)
    fn = lambda: k5.box_nms_topk(boxes, scores, 0.7, valid, PARITY_KEEP)
    return {"candidates": int(boxes.shape[1]), "picks": PARITY_KEEP,
            "picks_longest_image": int(picks.max()), "mismatches": errs,
            "latency_floor_ms": int(picks.max()) * rounds[1024],
            "design_floor_ms": floor, "scan_chunks_longest_image": chunks,
            "events_ms": elapsed_ms(torch, fn, 5),
            "cold_events_ms": cold_elapsed_ms(torch, fn, l2_flush(torch),
                                              5)}


def detection_people(rng, ids, S=DET_SIDE):
    """COCO-layout images with 1-4 person boxes each (40-200 x 80-380 px)
    on S x S uint8 canvases, from ``rng``. Returns (images, annotations,
    {image_id: canvas})."""
    canvases = rng.randint(0, 256, (len(ids), S, S, 3), np.uint8)
    images, anns = [], []
    for img_id in ids:
        images.append({"id": img_id, "height": S, "width": S,
                       "file_name": "%012d.jpg" % img_id})
        for _ in range(rng.randint(1, 5)):
            w, h = rng.uniform(40, 200), rng.uniform(80, 380)
            x, y = rng.uniform(0, S - w), rng.uniform(0, S - h)
            anns.append({"id": len(anns) + 1, "image_id": img_id,
                         "category_id": 1, "bbox": [x, y, w, h],
                         "area": w * h, "iscrowd": 0})
    return images, anns, dict(zip(ids, canvases))


def detection_dataset(root, seed):
    """``root``/annotations/person_keypoints_{train,val}.json of
    DET_TRAIN_IMAGES and DET_VALID_IMAGES images (``detection_people``).
    Returns {image_id: uint8 canvas}."""
    rng = np.random.RandomState(seed)
    canvases = {}
    for split, ids in (("train", range(1, DET_TRAIN_IMAGES + 1)),
                       ("val", range(1001, 1001 + DET_VALID_IMAGES))):
        images, anns, cv = detection_people(rng, list(ids))
        write_keypoints_file(root, split, images, anns)
        canvases.update(cv)
    return canvases


@contextlib.contextmanager
def environment(**values):
    """Environment variables set for the block, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def detector_epoch_clock(torch, trainer_cls, times):
    """Host ms of every train and validation epoch of any DetectorTrainer,
    each bracketed by a synchronise (``times["train"|"valid"]``), and
    what each ``training_loop`` starts from (``times["start"]``)."""
    saved = {n: getattr(trainer_cls, n) for n in
             ("train_epoch", "validation_epoch", "training_loop")}

    def timed(key, fn):
        def call(self, epoch, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, epoch, *a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def loop(self):
        times["start"].append({
            "epoch": self.cur_epoch, "step": int(self.state.step),
            "lr": self.state.optimizer.param_groups[0]["lr"],
            "scheduler": self.scheduler.state_dict()})
        return saved["training_loop"](self)

    trainer_cls.train_epoch = timed("train", saved["train_epoch"])
    trainer_cls.validation_epoch = timed("valid", saved["validation_epoch"])
    trainer_cls.training_loop = loop
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(trainer_cls, n, fn)


def first_varying_op(torch, fn):
    """Run ``fn(mode)`` twice, ``fn`` entering ``mode`` around the work to
    search: a dispatch mode that logs every ATen op (backward included)
    with checksums of its tensor inputs and outputs. Return the first op
    whose inputs are equal in both runs and whose outputs are not (the op
    that sums in a varying order), as "name (op k of n)", or a note of why
    none was found. Ops that allocate or re-point storage without writing
    it (``empty``, ``set_``) are left out."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def checksums(values):
        out = []
        for t in tree_flatten(values)[0]:
            if not isinstance(t, torch.Tensor) or t.numel() == 0:
                continue
            b = t.detach().contiguous().view(-1).view(torch.uint8)
            w = (b.view(torch.int32) if b.numel() % 4 == 0 else b) \
                .to(torch.int64)
            pos = torch.arange(w.numel(), device=w.device) % 8191 + 1
            out.append(torch.stack([w.sum(), (w * pos).sum()]))
        return out

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if "empty" in str(func) or "set_" in str(func):
                return func(*args, **kwargs)
            ins = checksums((args, kwargs))
            res = func(*args, **kwargs)
            self.ops.append((str(func), ins, checksums(res)))
            return res

    logs = []
    for _ in range(2):
        log = Log()
        fn(log)
        logs.append([(name, [x.tolist() for x in ins],
                      [x.tolist() for x in outs])
                     for name, ins, outs in log.ops])
    a, b = logs
    for k, (oa, ob) in enumerate(zip(a, b)):
        if oa[0] != ob[0]:
            return f"none: the two runs' ops diverge at op {k} ({oa[0]}, " \
                   f"{ob[0]})"
        if oa[1] == ob[1] and oa[2] != ob[2]:
            return f"{oa[0]} (op {k} of {len(a)})"
    return (f"none among {len(a)} ATen ops: the difference enters outside "
            f"them (a kernel of the port)")


def roi_backward_on_step(torch, k3, log):
    """K3b on the inputs it got in a detector train step (``log``: one
    ``calls_to`` record): the RoIs the step sampled, clustered around the
    people, unlike ``roi_scene``'s spread boxes. Against its plain version
    (within K3B_REL_TOL of the plain maps' max abs) and against itself (0.0
    run to run); CUDA-event ms warm and cold, the plain version's warm."""
    (args, kw, _), = log
    args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
    got = k3.roi_align_backward(*args, **kw)
    again = k3.roi_align_backward(*args, **kw)
    ref = k3.roi_align_backward_plain(*args, **kw)
    rel = max(float((a - r).abs().max()) for a, r in zip(got, ref)) / max(
        float(r.abs().max()) for r in ref)
    rerun = max(float((a - b).abs().max()) for a, b in zip(got, again))
    if rel > K3B_REL_TOL or rerun:
        fail(f"K3b on the train step's inputs: {rel} of the maps' max abs "
             f"from its plain version, {rerun} from itself run to run")
    levels = args[3]
    return {"boxes_by_level": torch.bincount(
        levels.flatten().long() + 1, minlength=5).tolist()[1:],
            "rel_err": rel, "run_to_run_max_abs": rerun,
            "inside_samples": inside_samples(
                torch, args[2], levels, [s[1] for s in args[1]], args[4]),
            **event_times(torch, {
                "": lambda: k3.roi_align_backward(*args, **kw),
                "plain_": lambda: k3.roi_align_backward_plain(*args, **kw)},
                cold=True)}


def detector_step_vs_plain(torch, mods, base, batch, seed):
    """FasterRCNN.loss_fn and its backward from the weights of ``base``
    and the same draws, on the kernels and on the plain versions (cuDNN
    deterministic): loss terms within STEP_LOSS_REL_TOL relative, every
    parameter's gradient within STEP_GRAD_TOL of its max abs. The kernels
    run twice: their gradients' run-to-run difference is recorded beside
    and, where it is not 0.0, the op that sums in a varying order
    (``first_varying_op``)."""
    import copy
    runs = {}

    def run(mode=contextlib.nullcontext()):
        model = copy.deepcopy(base)
        gen = torch.Generator(device=batch["image"].device).manual_seed(seed)
        with mode:
            total, terms = model.loss_fn(batch, gen)
            total.backward()
        return ({"total": float(total.detach()), **{
            k: float(v) for k, v in terms.items()}},
            {n: p.grad for n, p in model.named_parameters()})

    torch.backends.cudnn.deterministic = True
    try:
        for label in ("kernels", "kernels_again", "plain"):
            with (plain_versions(mods) if label == "plain"
                  else contextlib.nullcontext()):
                runs[label] = run()
        varying = None
        if any(not torch.equal(runs["kernels_again"][1][n], g)
               for n, g in runs["kernels"][1].items()):
            varying = first_varying_op(torch, run)
    finally:
        torch.backends.cudnn.deterministic = False
    (tk, gk), (tp, gp) = runs["kernels"], runs["plain"]
    loss_rel = {k: abs(tk[k] - tp[k]) / abs(tp[k]) for k in tp}

    def worst_grad(ga, gb):
        err = {n: float((ga[n] - gb[n]).abs().max() / gb[n].abs().max())
               for n in gb}
        worst = max(err, key=err.get)
        return worst, err[worst]

    worst, err = worst_grad(gk, gp)
    again, again_err = worst_grad(runs["kernels_again"][1], gk)
    rec = {"loss_rel_errs": loss_rel, "grad_max_err_of_max_abs": err,
           "grad_worst": worst, "kernels_run_to_run_grad_of_max_abs":
           again_err, "run_to_run_worst": again,
           "run_to_run_varying_op": varying, "losses": tk}
    if max(loss_rel.values()) > STEP_LOSS_REL_TOL or err > STEP_GRAD_TOL:
        fail(f"detector train step, kernels vs plain: {rec}")
    return rec


def detector_train_path(torch, mods, dev, args, tmp):
    """Detector training at full width (phase 5e): K5 at the parity
    budget; one train step (seeded weights and non-trivial BatchNorm,
    Adam) with every counter set to 0 first: finite loss terms, every
    parameter and running statistic moved, K3 f32, K3b and K5 launched;
    the step on the kernels against the plain versions; K3b on the
    step's own inputs (``roi_backward_on_step``); ms per step and
    samples/s, split into forward + loss and backward + update; one step
    of the torchvision-parity detector (K5 at M = 6,529);
    then the detector CLI in-process (01 -> 02 -> resume -> 03) with its
    epochs timed. Returns (launches by path, summary, (step, ms))."""
    import copy
    t0 = time.time()
    k3, k5 = mods["k3"], mods["k5"]
    parity_nms = check_nms_parity(torch, k5, dev, args.seed + 31)
    print("K5 at the parity training budget:", json.dumps(parity_nms),
          flush=True)
    cfg = mods["FasterRCNNConfig"]()
    data = os.path.join(tmp, "detection_data")
    canvases = detection_dataset(data, args.seed + 32)
    exp = mods["default_experiment_args"]()
    exp["training"]["batch_size"] = DET_B
    exp["dataset"]["image_size"] = cfg.image_size
    with detection_canvases_in_memory(mods, canvases):
        pipe = mods["get_detection_dataset"](exp, "train", data_path=data,
                                             num_workers=4, device=dev)
        batches = [mods["detector_device_batch"](b, dev) for b in pipe]
    if len(batches) != DET_TRAIN_IMAGES // DET_B:
        fail(f"detector training: {len(batches)} batches")
    det = seeded_bn_statistics(torch, seeded_weights(
        torch, mods["FasterRCNN"](cfg, dev), args.seed + 33), args.seed + 34)
    base = copy.deepcopy(det)
    exp_t = {"training": {"learning_rate": DET_LR, "optimizer": "adam"},
             "dataset": {"dataset_name": "coco"}}
    state = mods["create_train_state"](det, exp_t)
    step = mods["make_detector_train_step"]()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 35)
    step(state, batches[0], gen)                   # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    print(f"detector training set-up in {time.time() - t0:.1f} s",
          flush=True)
    before = {k: v.detach().clone() for k, v in det.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    reset_counts(mods)
    k3b_log = []
    with calls_to(k3, "roi_align_backward", k3b_log):
        metrics = step(state, batches[1], gen)
    torch.cuda.synchronize()
    launches = {"detector_training": launch_counts(mods)}
    metrics = {k: float(v) for k, v in metrics.items()}
    after = det.state_dict()
    still = [k for k, v in before.items() if torch.equal(v, after[k])]
    n = launches["detector_training"]
    print("detector train step launches:", json.dumps(
        {k: v for k, v in n.items() if v}), flush=True)
    if not all(np.isfinite(v) for v in metrics.values()) or \
            metrics["finite"] != 1.0 or still or \
            not (n["roi_align"] and n["roi_align_backward"]
                 and n["box_nms_topk"]):
        fail(f"detector train step: metrics {metrics}, unmoved "
             f"{still[:8]}, launches {n}")
    vs_plain = detector_step_vs_plain(torch, mods, base, batches[2],
                                      args.seed + 36)
    k3b_step = roi_backward_on_step(torch, k3, k3b_log)
    del k3b_log
    del base

    b = batches[3]
    step_ms = elapsed_ms(torch, lambda: step(state, b, gen), 5)
    fwd_ms = elapsed_ms(torch, lambda: det.loss_fn(b, gen), 5)

    pdet = seeded_weights(torch, mods["FasterRCNN"](
        mods["FASTER_RCNN_TORCHVISION_PARITY"], dev), args.seed + 33)
    pstate = mods["create_train_state"](pdet, exp_t)
    nms_log = []
    step(pstate, batches[0], gen)                  # warm-up
    reset_counts(mods)
    with calls_to(k5, "box_nms_topk", nms_log):
        pm = step(pstate, batches[1], gen)
    torch.cuda.synchronize()
    launches["detector_training_parity"] = launch_counts(mods)
    pm = {k: float(v) for k, v in pm.items()}
    m_parity = [int(a[0].shape[1]) for a, _, _ in nms_log]
    if m_parity != [sum(PARITY_LEVELS)] or not np.isfinite(pm["loss"]) \
            or launches["detector_training_parity"]["box_nms_topk"] != 1:
        fail(f"parity train step: NMS candidates {m_parity}, metrics {pm}")
    parity_ms = elapsed_ms(torch, lambda: step(pstate, b, gen), 3)
    del pdet, pstate

    times = {"train": [], "valid": [], "start": []}
    scripts = mods["scripts"]
    with engine_environment(mods, tmp), \
            environment(STLPOSE_DETECTOR_CONFIG=DET_CONFIG,
                        STLPOSE_DETECTOR_PRETRAINED=""), \
            detection_canvases_in_memory(mods, canvases), \
            detector_epoch_clock(torch, mods["DetectorTrainer"], times):
        exp_path = scripts["01_create_experiment"].main(
            ["-d", "detector_cli", "--dataset_name", "coco", "--batch_size",
             str(DET_B), "--num_epochs", "2", "--save_frequency", "1"])
        reset_counts(mods)
        trainer = scripts["02_train_faster_rcnn"].main(
            ["-d", exp_path, "--data_path", data])
        launches["detector_cli"] = launch_counts(mods)
        with open(os.path.join(exp_path, "detector_logs.json")) as f:
            logs = json.load(f)
        ckpts = sorted(mods["list_checkpoints"](exp_path, detector=True))
        sim = mods["PlateauScheduler"](
            factor=float(trainer.exp_data["training"]
                         ["learning_rate_factor"]),
            patience=int(trainer.exp_data["training"]["patience"]))
        lr = float(trainer.exp_data["training"]["learning_rate"])
        for ap in logs["valid_ap"]:
            lr = sim.step(ap, lr)
        held = {
            "2 finite train losses": len(logs["train_loss"]) == 2 and
            all(np.isfinite(logs["train_loss"])),
            "2 valid APs": len(logs["valid_ap"]) == 2 and
            all(-1.0 <= v <= 1.0 for v in logs["valid_ap"]),
            "checkpoints 0, 1, final": ckpts == ["0", "1", "final"],
            "plateau stepped on AP": trainer.scheduler.best ==
            max(logs["valid_ap"]) and
            mods["get_current_lr"](trainer.state.optimizer) == lr,
            "K3, K3b, K5 launched": all(launches["detector_cli"][k] for k in
                                        ("roi_align", "roi_align_backward",
                                         "box_nms_topk"))}
        del trainer
        resumed = scripts["02_train_faster_rcnn"].main(
            ["-d", exp_path, "--checkpoint", "1", "--resume_training",
             "true", "--data_path", data])
        held["resume from checkpoint 1"] = (
            times["start"][-1]["epoch"] == 1 and
            times["start"][-1]["step"] == 2 * DET_TRAIN_IMAGES // DET_B and
            resumed.state.step == 3 * DET_TRAIN_IMAGES // DET_B)
        del resumed
        stats = scripts["03_evaluate_faster_rcnn"].main(
            ["-d", exp_path, "--checkpoint", "final", "--data_path", data])
        held["12 stats, finite or -1"] = len(stats) == 12 and all(
            s == -1.0 or 0.0 <= s <= 1.0 for s in stats)
    if not all(held.values()):
        fail(f"detector CLI: logs {logs}, checkpoints {ckpts}, not held: "
             f"{[k for k, v in held.items() if not v]}")
    summary = {
        "config": "faster_rcnn (ResNet-50-FPN, C = 256, 400x400)",
        "batch": DET_B, "train_step_metrics": metrics,
        "launches_per_step": {k: v for k, v in
                              launches["detector_training"].items() if v},
        "kernels_vs_plain": vs_plain, "roi_backward_on_step": k3b_step,
        "ms_per_step": step_ms,
        "samples_per_s": DET_B / step_ms * 1e3,
        "forward_loss_ms": fwd_ms, "backward_update_ms": step_ms - fwd_ms,
        "parity": {"nms_candidates": m_parity, "loss": pm["loss"],
                   "ms_per_step": parity_ms, "nms_check": parity_nms},
        "cli": {"logs": logs, "ms_per_train_epoch": times["train"],
                "ms_per_valid_epoch": times["valid"],
                "starts": times["start"], "stats_03": list(stats)}}
    print("detector training:", json.dumps(summary), flush=True)
    return launches, summary, ((lambda: step(state, b, gen)), step_ms)


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
    import importlib
    from stlpose_tpu_torch.config import (CONFIG, IMAGENET_STD,
                                          FasterRCNNConfig,
                                          default_experiment_args,
                                          get_hrnet_config)
    from stlpose_tpu_torch.data.detection_dataset import \
        DetectionDataPipeline
    from stlpose_tpu_torch.data.loaders import (get_detection_dataset,
                                                get_vase_subset)
    from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
    from stlpose_tpu_torch.data.pose_dataset import (AugmentationParams,
                                                     PoseRecord, _xywh_to_cs)
    from stlpose_tpu_torch.config import FASTER_RCNN_TORCHVISION_PARITY
    from stlpose_tpu_torch.engines import detector_trainer
    from stlpose_tpu_torch.engines.evaluator import (PoseEvaluator,
                                                     device_batch)
    from stlpose_tpu_torch.engines.trainer import PoseTrainer
    from stlpose_tpu_torch.engines.vase_evaluator import (
        VaseEvaluator, build_fused_two_stage)
    from stlpose_tpu_torch.eval.submission import (compute_precision,
                                                   generate_submission)
    from stlpose_tpu_torch.kernels import _build
    from stlpose_tpu_torch.kernels import decode as k1
    from stlpose_tpu_torch.kernels import nms as k5
    from stlpose_tpu_torch.kernels import quantize as k3q
    from stlpose_tpu_torch.kernels import roi_align as k3
    from stlpose_tpu_torch.kernels import warp as k2
    from stlpose_tpu_torch.kernels import warp_two_pass as k4
    from stlpose_tpu_torch.models import adain, convert, vgg
    from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
    from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
    from stlpose_tpu_torch.models.quantize import (apply_trunk_flavor,
                                                   fold_batchnorms)
    from stlpose_tpu_torch.ops import affine
    from stlpose_tpu_torch.ops import roi_align as roi_ops
    from stlpose_tpu_torch.ops.decode import decode_heatmaps
    from stlpose_tpu_torch.ops.flip import average_flip_tta
    from stlpose_tpu_torch.ops.nms import box_nms_topk
    from stlpose_tpu_torch.ops.warp import affine_warp, two_pass_params
    from stlpose_tpu_torch.parallel import steps
    from stlpose_tpu_torch.parallel.detector_steps import \
        make_detector_train_step
    from stlpose_tpu_torch.parallel.steps import (MetricAccumulator,
                                                  make_eval_decode_step,
                                                  make_eval_step,
                                                  make_train_step)
    from stlpose_tpu_torch.train.optim import (PlateauScheduler,
                                               build_scheduler,
                                               get_current_lr,
                                               set_current_lr)
    from stlpose_tpu_torch.train.state import create_train_state
    from stlpose_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    list_checkpoints,
                                                    save_checkpoint)
    from stlpose_tpu_torch.utils.experiment import (
        create_experiment, load_experiment_parameters,
        save_experiment_parameters)
    scripts = {name: importlib.import_module(
        f"stlpose_tpu_torch.scripts.{name}") for name in
        ("01_create_experiment", "02_train", "03_evaluate",
         "aux_train_adain_decoder", "aux_styled_coco_preload",
         "aux_create_offline_perceptual_loss", "02_train_faster_rcnn",
         "03_evaluate_faster_rcnn")}

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
                         "warp_two_pass", "nms", "roi_align_backward"])
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
                fold_batchnorms=fold_batchnorms,
                PoseEvaluator=PoseEvaluator, device_batch=device_batch,
                create_experiment=create_experiment,
                load_experiment_parameters=load_experiment_parameters,
                save_checkpoint=save_checkpoint,
                make_eval_decode_step=make_eval_decode_step, steps=steps,
                average_flip_tta=average_flip_tta,
                decode_heatmaps=decode_heatmaps,
                generate_submission=generate_submission,
                compute_precision=compute_precision,
                IMAGENET_STD=IMAGENET_STD, CONFIG=CONFIG,
                PoseTrainer=PoseTrainer, scripts=scripts,
                save_experiment_parameters=save_experiment_parameters,
                checkpoint_path=checkpoint_path, VaseEvaluator=VaseEvaluator,
                DetectionDataPipeline=DetectionDataPipeline,
                get_vase_subset=get_vase_subset, adain=adain, vgg=vgg,
                convert=convert,
                AdaINStylizer=adain.AdaINStylizer,
                get_detection_dataset=get_detection_dataset,
                default_experiment_args=default_experiment_args,
                FASTER_RCNN_TORCHVISION_PARITY=FASTER_RCNN_TORCHVISION_PARITY,
                make_detector_train_step=make_detector_train_step,
                DetectorTrainer=detector_trainer.DetectorTrainer,
                detector_device_batch=detector_trainer._device_batch,
                list_checkpoints=list_checkpoints,
                PlateauScheduler=PlateauScheduler)
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    checks = [check_decode(torch, k1, dev, rng),
              check_warp(torch, k2, affine, affine_warp, dev, rng)]
    scene = roi_scene(torch, roi_ops, dev, rng)
    odd = odd_roi_scene(torch, roi_ops, dev, rng)
    checks.append(check_quantize(torch, k3q, scene, odd))
    checks += [check_roi_variant(torch, k3, k3q, roi_ops, scene, odd,
                                 variant)
               for variant in ROI_RECORDS]
    checks.append(check_roi_backward(torch, k3, roi_ops, scene, odd, dev,
                                     rng))
    checks.append(check_warp_two_pass(torch, k4, mods, dev, args.seed + 5))
    checks.append(check_nms(torch, k5, dev, args.seed + 11))
    for k, _ in checks:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']} (tol "
              f"{k['tolerance']})", flush=True)

    launches, tput, state = main_path(torch, mods, dev, args)
    stages = stage_times(torch, mods, state)
    q_launches, quant, q_state = quant_path(torch, mods, dev, args)
    with tempfile.TemporaryDirectory() as tmp:
        vase_launches, vase, vase_state = vase_path(torch, mods, dev, args,
                                                    tmp, state)
    vase["card"] = card
    train_launches, train, train_forms = train_path(torch, mods, dev, args)
    with tempfile.TemporaryDirectory() as tmp:
        eval_launches, evaluation, eval_state = eval_path(torch, mods, dev,
                                                          args, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        trainer_launches, trainer, trainer_state = trainer_path(
            torch, mods, dev, args, tmp, train["ms_per_step"])
    with tempfile.TemporaryDirectory() as tmp:
        style_launches, style, style_state = style_path(torch, mods, dev,
                                                        args, tmp)
    style["card"] = card
    with tempfile.TemporaryDirectory() as tmp:
        det_launches, det_train, (det_step, det_step_ms) = \
            detector_train_path(torch, mods, dev, args, tmp)
    det_train["card"] = card
    next(k for k, _ in checks if k["name"] == "box_nms_topk")["shapes"][
        "train_parity"] = det_train["parity"]["nms_check"]
    next(k for k, _ in checks if k["name"] == "roi_align_backward")[
        "detector_step_inputs"] = det_train["roi_backward_on_step"]

    # torch.profiler from here on: every host-clock and CUDA-event time
    # above was taken before its first session
    kernels = []
    for k, fns in checks:
        device_times(torch, k, fns)
        by_path = {"serving": launches[k["name"]],
                   "serving_bf16_roi8": q_launches[k["name"]],
                   **{p: n[k["name"]] for p, n in vase_launches.items()},
                   "training": train_launches[k["name"]],
                   "eval": eval_launches[k["name"]],
                   "trainer": trainer_launches[k["name"]],
                   "style": style_launches[k["name"]],
                   **{p: n[k["name"]] for p, n in det_launches.items()}}
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
    train["profile"] = profile_program(
        torch, train_forms["guarded"], train["ms_per_step"], args.out,
        "one training iteration")
    train["profile_model_train_each_step"] = profile_program(
        torch, train_forms["model_train_each_step"], float(np.median(
            train["train_mode_guard_ms"]["model_train_each_step"])),
        args.out, "one training iteration, model.train() before the step")
    canvases, engines = trainer_state
    with canvases_in_memory(mods, canvases):
        for dtype, (engine, engine_ms) in engines.items():
            trainer["profile" if dtype == "f32" else f"profile_{dtype}"] = \
                profile_program(torch, engine_iteration(mods, engine),
                                engine_ms, args.out, "one engine training "
                                f"iteration (PoseTrainer, B = 32, {dtype})")

    style_trainer, style_it_ms, (style_call, style_call_ms) = style_state
    style["profile_stylizer"] = profile_program(
        torch, style_call, style_call_ms, args.out,
        f"one stylizer call (B = {TRAIN_B}, 256x192 crops)")
    with crops_in_memory(mods):
        style["profile_iteration"] = profile_program(
            torch, engine_iteration(mods, style_trainer), style_it_ms,
            args.out, f"one style engine iteration (PoseTrainer, B = "
            f"{TRAIN_B}, host warp, crops stylized)")
    del style_trainer, style_call, style_state

    ev1, ev8, vase_images, b1_ms, b8_ms = vase_state
    for label, engine, images, ms in (
            ("B = 1", ev1, vase_images[:1], b1_ms),
            (f"B = {B}", ev8, vase_images, b8_ms)):
        vase["profile_b1" if images.shape[0] == 1 else "profile_b8"] = \
            profile_program(torch, lambda e=engine, x=images:
                            e.process_images(x), ms, args.out,
                            f"one vase engine call ({label}, VaseEvaluator)")
    del ev1, ev8

    det_train["profile"] = profile_program(
        torch, det_step, det_step_ms, args.out,
        f"one detector train step (B = {DET_B}, ResNet-50-FPN, f32)",
        expect=("roi_align_kernel", "roi_backward_footprint_kernel",
                "roi_backward_gather_kernel", "nms_sort_kernel",
                "nms_mask_kernel", "nms_scan_kernel"))
    del det_step

    fns, devb, forms = eval_state
    for form, fn in fns.items():
        evaluation["profile" if form == "nhwc_view" else
                   f"profile_{form}"] = profile_program(
            torch, lambda: fn(devb), float(np.median(forms[form]["step_ms"])),
            args.out, f"one eval-decode step (B = 64, flip-TTA, {form})")

    print(card)
    print(json.dumps({"kernels": kernels, "end_to_end": tput,
                      "stages_ms": stages, "profile": prof,
                      "serving_bf16_roi8": quant, "vase": vase,
                      "training": train,
                      "eval": evaluation, "trainer": trainer,
                      "style": style, "detector_training": det_train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
