"""Driver: the retrieval database's extraction loop of
05_create_archdata_retrieval_db (``ArchDataExtractor``'s
``extract_retrieval_dataset`` body: the eval pipeline's device-warp
collate, ``batch_peaks`` (flip-TTA HRNet and K1), the fetch of the peaks
and ``add_batch``), over seeded figure images held in memory.

Traffic keys: ``batch``, ``images`` (a multiple of ``batch``), their
``height`` x ``width``, ``canvas`` (the letterbox side), ``kpt_thr``,
``num_workers`` (the pipeline's decode threads) and ``judged_batches``.
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
from portbench.flops import hrnet_flops
from portbench.reference import judge

INPUT_SPAN = "collate"


def figure_records(rng, n, height, width):
    """One figure a seeded image: a box inside it, its HRNet centre and
    scale (grown to 192:256, padded 1.25x)."""
    w = rng.uniform(0.3, 0.9, n) * width
    h = rng.uniform(0.4, 0.95, n) * height
    x = rng.uniform(0, 1, n) * (width - w)
    y = rng.uniform(0, 1, n) * (height - h)
    ar = 192.0 / 256.0
    hh = np.where(w > ar * h, w / ar, h)
    ww = np.maximum(w, hh * ar)
    centers = np.stack([x + 0.5 * w, y + 0.5 * h], -1).astype(np.float32)
    scales = (np.stack([ww, hh], -1) / 200.0 * 1.25).astype(np.float32)
    return centers, scales


class ExtractJob:
    def __init__(self, ctx):
        from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
        from stlpose_tpu_torch.data.pose_dataset import PoseRecord
        from stlpose_tpu_torch.engines.retrieval_db import ArchDataExtractor
        from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
        from stlpose_tpu_torch.parallel.mesh import get_mesh
        from stlpose_tpu_torch.parallel.steps import make_infer_fn
        self.ctx = ctx
        dev = ctx.device
        t = ctx.workload["traffic"]
        self.t = t
        self.pcfg = ctx.config["pose"]
        model = PoseHighResolutionNet(port.hrnet_config(self.pcfg),
                                      device=dev)
        self.Wp = port.seeded_state(torch, model,
                                    H.sub_seed(ctx.seed, "pose"), dev)
        model.load_state_dict(self.Wp)
        n, B = t["images"], t["batch"]
        if n % B:
            raise H.BenchError("images must be a multiple of the batch")
        g = torch.Generator(device=dev).manual_seed(
            H.sub_seed(ctx.seed, "images"))
        self.images = torch.randint(0, 256, (n, t["height"], t["width"], 3),
                                    generator=g, device=dev,
                                    dtype=torch.uint8).cpu().numpy()
        rng = np.random.default_rng(H.sub_seed(ctx.seed, "records"))
        self.centers, self.scales = figure_records(rng, n, t["height"],
                                                   t["width"])
        zeros = np.zeros((self.pcfg["num_joints"], 2), np.float32)
        self.records = [PoseRecord(
            image=f"figure_{i}.jpg", original_image=f"figure_{i}.jpg",
            image_id=i, center=self.centers[i], scale=self.scales[i],
            joints=zeros, joints_vis=np.zeros(len(zeros), np.float32),
            character_name=f"character_{i % 12}") for i in range(n)]
        pipe = PoseDataPipeline(self.records, B, is_train=False,
                                num_workers=t["num_workers"],
                                device_warp=True, canvas_size=t["canvas"],
                                device=dev)
        pipe._load_one_raw = lambda rec: pipe._letterbox(
            self.images[rec.image_id], rec)
        exp = self._exp = tempfile.mkdtemp(prefix="portbench-")
        with open(os.path.join(exp, "experiment_parameters.json"), "w") as f:
            json.dump({"dataset": {"dataset_name": "arch_data"},
                       "training": {"learning_rate": 1e-3}}, f)
        ext = ArchDataExtractor(exp, kpt_thr=t["kpt_thr"], device=dev)
        ext.mesh = get_mesh(device=dev)
        ext.model = model
        ext.infer = make_infer_fn(model, flip_tta=True, decode=False,
                                  mesh=ext.mesh)
        ext.pipe = pipe
        self.ext = ext
        self.flops_per_call = 2 * B * hrnet_flops(self.Wp, self.pcfg)
        self._batches = self._endless()
        self.keep, self.kept = False, []
        for _ in range(2):                      # the one shape this cell uses
            self.iteration(0)
        self.ext.retrieval_db = {}
        self.keep = True

    def _endless(self):
        while True:
            for b, batch in enumerate(self.ext.pipe):
                yield b, batch

    def iteration(self, k):
        """One batch of ``extract_retrieval_dataset``."""
        from stlpose_tpu_torch.parallel.distributed import all_gather_host
        spans, ext = self.ctx.spans, self.ext
        with spans("collate"):
            b, batch = next(self._batches)
        with spans("peaks"):
            peaks, hw = ext.batch_peaks(batch["image"],
                                        batch["image"].shape[0])
        with spans("fetch"):
            peaks = all_gather_host(peaks.cpu().numpy())[:batch["n_valid"]]
        with spans("host_entry"):
            first = len(ext.retrieval_db)
            ext.add_batch(peaks, hw, batch, ext.pipe.records)
        if self.keep:
            entries = np.stack([ext.retrieval_db[f"img_{i}"]["joints"]
                                for i in range(first, first + len(peaks))])
            self.kept.append((b, peaks, entries))
        return len(peaks)

    def finish(self):
        pass

    def end_to_end(self, win):
        return {"poses_per_s": win["units"] / win["seconds"]}

    def release(self):
        self.ext = None
        shutil.rmtree(self._exp, ignore_errors=True)
        self._batches = None
        torch.cuda.empty_cache()

    def samples(self, win):
        n = len(self.kept)
        rng = np.random.default_rng(H.sub_seed(self.ctx.seed, "judge"))
        return sorted(rng.choice(n, min(n, self.t["judged_batches"]),
                                 replace=False).tolist())

    def _inputs(self, b):
        """Batch ``b``'s letterboxed canvases and records, on the device."""
        B, S = self.t["batch"], self.t["canvas"]
        rows = slice(b * B, (b + 1) * B)
        img = self.images[rows]
        canv = np.zeros((B, S, S, 3), np.uint8)
        canv[:, :img.shape[1], :img.shape[2]] = img
        dev = self.ctx.device
        return (torch.from_numpy(canv).to(dev),
                torch.from_numpy(self.centers[rows]).to(dev),
                torch.from_numpy(self.scales[rows]).to(dev))

    def program_outputs(self, win):
        return [self.kept[i] for i in self.samples(win)]

    def control_outputs(self, win):
        with torch.no_grad():
            return [(b, *judge.extract_results(self.Wp, self.pcfg,
                                               *self._inputs(b),
                                               self.t["kpt_thr"]))
                    for b, _, _ in self.program_outputs(win)]

    def judge_outputs(self, outputs):
        with torch.no_grad():
            return [judge.extract(self.Wp, self.pcfg, *self._inputs(b),
                                  peaks, entries, self.t["kpt_thr"])
                    for b, peaks, entries in outputs]


def setup(ctx):
    return ExtractJob(ctx)
