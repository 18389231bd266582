"""Driver: the two-stage serving program of 04_evaluate_vases_qualitatively
(``VaseEvaluator.process_images(use_fused=True)``: Faster R-CNN, score
filter, cross-batch crop compaction, crops, HRNet, decode) under one
closed-loop client handing it batches of uint8 images from the host.

Traffic keys: ``batch`` images a call, ``image_size`` their side,
``batches`` distinct seeded batches cycled through, ``bbox_thr``,
``kpt_thr``, ``max_dets``, ``crop_budget`` (the engine's arguments), and
``judged_calls`` the calls of the window the reference recomputes.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from portbench import harness as H
from portbench import port
from portbench.flops import detector_flops, hrnet_flops
from portbench.reference import judge

INPUT_SPAN = None


class ServeJob:
    def __init__(self, ctx):
        from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator
        from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
        from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
        self.ctx = ctx
        dev = ctx.device
        t = ctx.workload["traffic"]
        self.t = t
        self.dcfg, self.pcfg = ctx.config["detector"], ctx.config["pose"]
        if t["image_size"] != self.dcfg["image_size"]:
            raise H.BenchError("images must be the detector's canvas size")
        det_cfg = port.frcnn_config(self.dcfg)
        det = FasterRCNN(det_cfg, device=dev)
        self.Wd = port.seeded_state(torch, det, H.sub_seed(ctx.seed, "det"),
                                    dev)
        det.load_state_dict(self.Wd)
        pose = PoseHighResolutionNet(port.hrnet_config(self.pcfg),
                                     device=dev)
        self.Wp = port.seeded_state(torch, pose,
                                    H.sub_seed(ctx.seed, "pose"), dev)
        pose.load_state_dict(self.Wp)
        exp = self._exp = tempfile.mkdtemp(prefix="portbench-")
        with open(os.path.join(exp, "experiment_parameters.json"), "w") as f:
            json.dump({"model": {"detector_name": "faster_rcnn"},
                       "dataset": {}, "training": {}}, f)
        ev = VaseEvaluator(exp, bbox_thr=t["bbox_thr"], kpt_thr=t["kpt_thr"],
                           max_dets=t["max_dets"], save=False, use_fused=True,
                           crop_budget=t["crop_budget"], device=dev)
        ev.detector, ev.det_cfg, ev.pose_model = det, det_cfg, pose
        self.ev = ev
        B, S = t["batch"], t["image_size"]
        g = torch.Generator(device=dev).manual_seed(
            H.sub_seed(ctx.seed, "images"))
        self.pool = torch.randint(0, 256, (t["batches"], B, S, S, 3),
                                  generator=g, device=dev,
                                  dtype=torch.uint8).cpu().numpy()
        self.B = B
        self.budget = ev._fused_budget(B)
        self.params = {"max_dets": min(t["max_dets"],
                                       self.dcfg["detections_per_img"]),
                       "budget": self.budget, "bbox_thr": t["bbox_thr"],
                       "kpt_thr": t["kpt_thr"]}
        self.flops_per_call = (B * detector_flops(self.Wd, self.dcfg) +
                               self.budget * hrnet_flops(self.Wp, self.pcfg))
        for _ in range(2):                      # the one shape this cell uses
            ev.process_images(self.pool[0], use_fused=True)
        self._span_engine()
        self.keep = True
        self.calls = []

    def _span_engine(self):
        """Host spans around the engine's upload, program and fetch."""
        ev, spans = self.ev, self.ctx.spans

        def spanned(name, fn):
            def call(*a):
                with spans(name):
                    return fn(*a)
            return call

        ev._upload = spanned("upload", ev._upload)
        ev._unpack = spanned("fetch_unpack", ev._unpack)
        for key, (prog, spec) in list(ev._fused_cache.items()):
            ev._fused_cache[key] = (spanned("program", prog), spec)

    def iteration(self, k):
        b = k % len(self.pool)
        with self.ctx.spans("call"):
            res = self.ev.process_images(self.pool[b], use_fused=True)
        if self.keep:
            self.calls.append((b, res))
        return self.B

    def finish(self):
        pass

    def end_to_end(self, win):
        return {"images_per_s": win["units"] / win["seconds"],
                "latency_ms_p95": H.percentile(win["latencies_s"], 95) * 1e3}

    def release(self):
        self.ev = None
        shutil.rmtree(self._exp, ignore_errors=True)
        torch.cuda.empty_cache()

    def samples(self, win):
        """Indices of the judged calls: drawn from the seed, with the
        slowest call of the window among them."""
        n = len(self.calls)
        rng = np.random.default_rng(H.sub_seed(self.ctx.seed, "judge"))
        pick = set(rng.choice(n, min(n, self.t["judged_calls"]),
                              replace=False).tolist())
        pick.add(int(np.argmax(win["latencies_s"][:n])))
        return sorted(pick)

    def program_outputs(self, win):
        return [self.calls[i] for i in self.samples(win)]

    def control_outputs(self, win):
        """The reference in the program's place, on the same calls."""
        with torch.no_grad():
            return [(b, judge.serve_results(
                self.Wd, self.dcfg, self.Wp, self.pcfg,
                torch.from_numpy(self.pool[b]).to(self.ctx.device),
                self.params)) for b, _ in self.program_outputs(win)]

    def judge_outputs(self, outputs):
        with torch.no_grad():
            return [judge.serve(self.Wd, self.dcfg, self.Wp, self.pcfg,
                                torch.from_numpy(self.pool[b]).to(
                                    self.ctx.device), res, self.params)
                    for b, res in outputs]


def setup(ctx):
    return ServeJob(ctx)
