#!/usr/bin/env python3
"""Host cost of the int8 serving path's kernel calls, on one GPU.

    python3 chip_host_time.py [--root DIR] [--seed 0] [--iters 10]
        [--rounds 9]

Imports ``stlpose_tpu_torch`` from ``--root`` (default: this script's
directory; another checkout, e.g. a parent commit unpacked with
``git archive``, to compare two trees in one run on one card), builds its
kernels and, with the seeded weights and BatchNorm of ``chip_smoke.py``'s
int8 phase (helpers taken from the ``chip_smoke.py`` beside this script):

- K6's and K6q's cost per call over one int8 ResNet-50 trunk at
  400x400, B = 8, f32 (the 52 ``int8_conv`` and 48 ``quantize_activations``
  calls one forward makes, recorded and replayed as called): the CUDA-event
  time of back-to-back replays over the calls (launch gaps included, so
  the host's cost where it is the longer), and the host's issue time
  alone; through the wrappers and, where the tree has operators, through
  the dispatcher (as a loaded ``torch.export`` program calls them) and
  into each operator's CUDA implementation directly (the launch alone);
- HRNet-W32 int8 on 64 crops (CUDA events, back-to-back calls);
- the full int8 stack's fused call (bf16, int8 trunk, int8 RoI pyramid,
  HRNet-W32 bf16 folded; B = 8, host clock, synchronised).

Each time is read ``--rounds`` times and kept as (least, median): the
host's speed varies between readings on a shared machine.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line.
Without a CUDA device it exits non-zero before running anything.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def helpers():
    """``chip_smoke.py`` beside this script, as a module (its import runs
    no torch)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded_calls(k6, fn):
    """The (name, args, kwargs) of every K6 and K6q wrapper call that
    ``fn()`` makes, each call still made."""
    calls, saved = [], {}
    for name in ("int8_conv", "quantize_activations"):
        wrapped = saved[name] = getattr(k6, name)

        def logged(*a, _name=name, _fn=wrapped, **kw):
            calls.append((_name, a, kw))
            return _fn(*a, **kw)

        setattr(k6, name, logged)
    try:
        fn()
    finally:
        for name, wrapped in saved.items():
            setattr(k6, name, wrapped)
    return calls


def per_call_us(torch, calls, reps, rounds, call):
    """Per call of replaying ``calls`` with ``call(name, args, kwargs)``
    ``reps`` times back to back, after one warm-up replay, over ``rounds``
    rounds: the CUDA-event µs and the host-issue µs, each as (least,
    median) over the rounds."""
    import numpy as np

    def replay():
        for name, a, kw in calls:
            call(name, a, kw)

    replay()
    torch.cuda.synchronize()
    ev, host = [], []
    n = reps * len(calls)
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            replay()
        host.append((time.perf_counter() - t) * 1e6 / n)
        end.record()
        end.synchronize()
        ev.append(start.elapsed_time(end) * 1e3 / n)
    return {"event_us": [min(ev), float(np.median(ev))],
            "host_issue_us": [min(host), float(np.median(host))]}


def call_forms(k6):
    """How a recorded call is replayed: through the wrapper (what an eager
    forward runs) and, where the tree has operators, through the
    dispatcher (what a loaded ``torch.export`` program runs) and straight
    into the operator's CUDA implementation (the launch alone)."""
    forms = {"wrapper": lambda name, a, kw: getattr(k6, name)(*a, **kw)}
    ops = {"int8_conv": getattr(k6, "OP", None),
           "quantize_activations": getattr(k6, "QUANTIZE_OP", None)}
    if all(ops.values()):
        forms["operator"] = lambda name, a, kw: ops[name].overload(
            *full_args(name, a, kw))
        forms["cuda_implementation"] = lambda name, a, kw: ops[name].impls[
            "cuda"](*full_args(name, a, kw))
    return forms


def full_args(name, a, kw):
    """A wrapper call's arguments in the order of its operator's CUDA
    implementation. ``ConvBN`` passes every argument by position but K6's
    ``route`` (its default, None) and K6q's absent zero point (None)."""
    if kw:
        raise ValueError(f"{name}: keyword arguments {sorted(kw)}")
    return list(a) + [None] * ((5 if name == "quantize_activations"
                                else 11) - len(a))


def timed_rounds(torch, fn, rounds, timer):
    """(least, median) over ``rounds`` readings of ``timer(torch, fn)``."""
    import numpy as np

    v = [timer(torch, fn) for _ in range(rounds)]
    return [min(v), float(np.median(v))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose stlpose_tpu_torch is measured")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10,
                    help="calls (replays of the trunk's calls) per reading")
    ap.add_argument("--rounds", type=int, default=9,
                    help="readings of each time; least and median kept")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_host_time: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import stlpose_tpu_torch
    if not os.path.abspath(stlpose_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"stlpose_tpu_torch came from "
                           f"{stlpose_tpu_torch.__file__}, not {root}")
    from stlpose_tpu_torch.config import FasterRCNNConfig, get_hrnet_config
    from stlpose_tpu_torch.engines.vase_evaluator import \
        build_fused_two_stage
    from stlpose_tpu_torch.kernels import _build
    from stlpose_tpu_torch.kernels import int8_conv as k6
    from stlpose_tpu_torch.models.convert import load_strict
    from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
    from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
    from stlpose_tpu_torch.models.quantize import (
        flavored_state_dict, fold_batchnorms, quantize_hrnet_from_batches)
    cs = helpers()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.time()
    _build.build(_build.SOURCES)
    build_s = time.time() - t0

    cfg, hcfg = FasterRCNNConfig(), get_hrnet_config("w32_256x192")
    det = cs.seeded_bn_statistics(torch, cs.seeded_weights(
        torch, FasterRCNN(cfg, device=dev), args.seed + 6), args.seed + 7)
    pose = cs.seeded_bn_statistics(torch, cs.seeded_weights(
        torch, PoseHighResolutionNet(hcfg, device=dev), args.seed + 8),
        args.seed + 9)
    live = {k: v for k, v in det.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    pose_sd = {k: v for k, v in pose.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    images = cs.serving_images(torch, dev, args.seed + 2)
    calib = cs.serving_images(torch, dev, args.seed + 50).float() / 255.0
    x01 = (images.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    out = {"root": root, "card": card, "torch": torch.__version__,
           "build_s": build_s}

    # K6 and K6q over one int8 trunk, as a forward calls them
    det_q = load_strict(FasterRCNN(cfg, device=dev, trunk_quant="int8"),
                        flavored_state_dict(live, "int8", config=cfg,
                                            calib_batches=[calib]))
    with torch.inference_mode():
        calls = recorded_calls(k6, lambda: det_q.backbone(x01))
        for name in ("int8_conv", "quantize_activations"):
            mine = [c for c in calls if c[0] == name]
            out[name] = {"calls": len(mine), **{
                form: per_call_us(torch, mine, args.iters, args.rounds, call)
                for form, call in call_forms(k6).items()}}
    del det_q, calls

    # HRNet-W32 int8 on 64 crops
    g = torch.Generator(device=dev).manual_seed(args.seed + 51)
    calib_crops = torch.randn((64, 256, 192, 3), generator=g, device=dev)
    crops = torch.randn((64, 256, 192, 3), generator=g, device=dev)
    _, model = quantize_hrnet_from_batches("w32_256x192", pose_sd,
                                           [calib_crops], device=dev)
    with torch.inference_mode():
        out["hrnet_int8_ms_64_crops"] = timed_rounds(
            torch, lambda: model(crops), args.rounds,
            lambda t, f: cs.elapsed_ms(t, f, args.iters))
    del model

    # the full int8 stack's fused call
    det_s = load_strict(FasterRCNN(
        cfg, device=dev, dtype=torch.bfloat16, roi_patch_quant=True,
        trunk_quant="int8"), flavored_state_dict(
            live, "int8", config=cfg, calib_batches=[calib],
            dtype=torch.bfloat16))
    pose_s = load_strict(PoseHighResolutionNet(
        hcfg, device=dev, dtype=torch.bfloat16, folded=True),
        fold_batchnorms(pose_sd))
    fused = build_fused_two_stage(det_s, pose_s, bbox_thr=cs.BBOX_THR,
                                  max_dets=cs.MAX_DETS, budget=cs.BUDGET,
                                  device=dev)
    out["int8_stack_ms_per_call"] = timed_rounds(
        torch, lambda: fused(images), args.rounds,
        lambda t, f: cs.host_ms(t, f, args.iters))
    out["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
