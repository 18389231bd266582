"""Driver: the pose fine-tuning loop of 02_train (the body of
``PoseTrainer._run_train_epoch``: the device-warp train pipeline's next
batch, ``train_step(state, _step_view(batch))`` and the device-side
metric accumulator), over seeded COCO-sized canvases with one person
record each, held in memory.

Set-up builds the one train state the window trains: the seeded weights,
then the first three steps through the window's own call and feed on
rows that all differ, their losses, the first gradient (from Adam's
first moment after step 1) and each leaf's change after step 3 kept for
the comparison with the reference, which follows those three steps.

Traffic keys: ``batch``, ``records`` (a multiple of ``batch``, at least
three batches), ``canvas`` (the images' side, the letterbox size),
``num_workers`` (the pipeline's decode threads; they take the
augmentation sampler in turn, and the order of the draws is noted for the
reference), ``checked_steps``.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench import harness as H
from portbench import port
from portbench.flops import hrnet_flops
from portbench.reference import train as ref_train

INPUT_SPAN = "next_batch"


def person_records(rng, n, canvas, joints):
    """One person a canvas: a box, its centre and scale (grown to 192:256,
    padded 1.25x), joints inside the box (80% visible), a perceptual
    loss in [0, 1)."""
    w = rng.uniform(80, 300, n)
    h = rng.uniform(150, 450, n)
    x = rng.uniform(0, 1, n) * (canvas - w)
    y = rng.uniform(0, 1, n) * (canvas - h)
    ar = 192.0 / 256.0
    hh = np.where(w > ar * h, w / ar, h)
    ww = np.maximum(w, hh * ar)
    return {"centers": np.stack([x + 0.5 * w, y + 0.5 * h],
                                -1).astype(np.float32),
            "scales": (np.stack([ww, hh], -1) / 200.0 *
                       1.25).astype(np.float32),
            "joints": np.stack([x[:, None] + rng.uniform(0, 1, (n, joints)) *
                                w[:, None],
                                y[:, None] + rng.uniform(0, 1, (n, joints)) *
                                h[:, None]], -1).astype(np.float32),
            "vis": (rng.uniform(0, 1, (n, joints)) > 0.2).astype(np.float32),
            "perceptual": rng.uniform(0, 1, n).astype(np.float32)}


class TrainJob:
    def __init__(self, ctx):
        from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
        from stlpose_tpu_torch.data.pose_dataset import PoseRecord
        from stlpose_tpu_torch.engines.trainer import PoseTrainer
        from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
        from stlpose_tpu_torch.parallel.mesh import get_mesh
        from stlpose_tpu_torch.parallel.steps import (MetricAccumulator,
                                                      make_train_step)
        from stlpose_tpu_torch.train.state import create_train_state
        self.ctx = ctx
        dev = ctx.device
        t = ctx.workload["traffic"]
        self.t = t
        cfg = ctx.config
        self.pcfg, self.tcfg = cfg["pose"], cfg["training"]
        exp = {"training": {"learning_rate": self.tcfg["learning_rate"],
                            "optimizer": self.tcfg["optimizer"],
                            "perceptual_loss": True},
               "dataset": {"dataset_name": "styled_coco",
                           "device_warp": True, **cfg["augmentation"]}}
        model = PoseHighResolutionNet(port.hrnet_config(self.pcfg), dev,
                                      torch.float32,
                                      param_dtype=torch.float32)
        self.Wp = port.seeded_state(torch, model,
                                    H.sub_seed(ctx.seed, "pose"), dev)
        model.load_state_dict(self.Wp)
        self.param_names = [n for n, _ in model.named_parameters()]
        self.state = create_train_state(model, exp)
        self.train_step = make_train_step(perceptual_cfg=exp)
        self.acc = MetricAccumulator()
        n, B, S = t["records"], t["batch"], t["canvas"]
        g = torch.Generator(device=dev).manual_seed(
            H.sub_seed(ctx.seed, "images"))
        self.images = torch.randint(0, 256, (n, S, S, 3), generator=g,
                                    device=dev,
                                    dtype=torch.uint8).cpu().numpy()
        rng = np.random.default_rng(H.sub_seed(ctx.seed, "records"))
        self.recs = person_records(rng, n, S, self.pcfg["num_joints"])
        records = [PoseRecord(
            image=f"person_{i}.jpg", original_image=f"person_{i}.jpg",
            image_id=i, center=self.recs["centers"][i],
            scale=self.recs["scales"][i], joints=self.recs["joints"][i],
            joints_vis=self.recs["vis"][i],
            perceptual_loss=float(self.recs["perceptual"][i]))
            for i in range(n)]
        self.draw_seed = H.sub_seed(ctx.seed, "augmentation")
        pipe = PoseDataPipeline(records, B, is_train=True, exp_data=exp,
                                shuffle=False, num_workers=t["num_workers"],
                                drop_last=True, seed=self.draw_seed,
                                device_warp=True, canvas_size=S, device=dev)
        pipe._load_one_raw = lambda rec: pipe._letterbox(
            self.images[rec.image_id], rec)
        self.pipe = pipe
        self._log_draw_order()
        self.view = types.SimpleNamespace(mesh=get_mesh(device=dev),
                                          device=dev)
        self._step_view = PoseTrainer._step_view
        self.B = B
        self.flops_per_call = 3 * B * hrnet_flops(self.Wp, self.pcfg)
        self._batches = self._endless()
        self._first_steps()
        self.keep = True

    def _endless(self):
        while True:
            yield from self.pipe

    def _log_draw_order(self):
        """Note which record takes each augmentation draw (the decode
        threads take the sampler in turn, in no fixed order), for the
        reference to draw in the same order; ``_first_steps`` removes the
        note."""
        index = {c.tobytes(): i for i, c in enumerate(self.recs["centers"])}
        aug, self.draw_order = self.pipe.aug, []

        def sample(center, *a):
            self.draw_order.append(index[center.tobytes()])
            return type(aug).sample(aug, center, *a)

        aug.sample = sample

    def _first_steps(self):
        """The first ``checked_steps`` steps of the window's own call; what
        the comparison needs is kept as it goes."""
        opt, b1 = self.state.optimizer, 0.9
        params = dict(self.state.model.named_parameters())
        self.batches_seen, losses = [], []
        for k in range(self.t["checked_steps"]):
            losses.append(self.iteration(k, keep_batch=True))
            if k == 0:
                self.first_grad = {
                    n: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                    if "exp_avg" in opt.state[p] else 0.0
                    for n, p in params.items()}
        del self.pipe.aug.sample
        self.losses = [float(x) for x in losses]
        self.change = {n: float((p.detach() - self.Wp[n]).norm())
                       for n, p in params.items()}

    def iteration(self, k, keep_batch=False):
        """One iteration of ``_run_train_epoch``'s loop body."""
        spans = self.ctx.spans
        with spans("next_batch"):
            batch = next(self._batches)
        with spans("step"):
            metrics = self.train_step(self.state,
                                      self._step_view(self.view, batch))
            self.acc.update(metrics)
        if keep_batch:
            self.batches_seen.append((batch["image"], batch["target"],
                                      batch["target_weight"]))
            return metrics["loss"]
        return self.B

    def finish(self):
        self.acc.fetch()              # the epoch's one fetch of the sums

    def end_to_end(self, win):
        return {"train_samples_per_s": win["units"] / win["seconds"]}

    def release(self):
        self.state = None
        self._batches = None
        self.pipe = None
        torch.cuda.empty_cache()

    def program_outputs(self, win):
        return {"losses": self.losses, "first_grad": self.first_grad,
                "change": self.change, "batches": self.batches_seen}

    def _reference(self, data_only=False):
        a = self.ctx.config["augmentation"]
        draws = ref_train.Draws(self.draw_seed, a["scale_factor"],
                                a["rot_factor"], a["flip"],
                                a["num_joints_half_body"],
                                a["prob_half_body"])
        data = ref_train.batches({"images": self.images, **self.recs}, draws,
                                 self.t["checked_steps"], self.B,
                                 self.ctx.device, self.draw_order)
        if data_only:
            return data
        return data, ref_train.steps(self.Wp, self.pcfg, self.param_names,
                                     data, self.tcfg["learning_rate"])

    def control_outputs(self, win):
        data, (losses, first, change) = self._reference()
        return {"losses": losses, "first_grad": first, "change": change,
                "batches": [d[:3] for d in data]}

    def judge_outputs(self, out):
        """Each step's loss (the first one's apart, and the worst of the
        checked steps), the worst leaf's first gradient, and the median
        and the worst leaf's change after the checked steps, each as a gap
        of norms over the reference's (or the median leaf's, if larger);
        the first batches' crops and targets go along as a record."""
        data, (losses, first, change) = self._reference()
        med_g = float(np.median(list(first.values())))
        med_c = float(np.median(list(change.values())))

        def gaps(prog, ref, med, names):
            return sorted(((abs(prog[n] - ref[n]) / max(ref[n], med), n)
                           for n in names), reverse=True)

        # leaves whose first gradient is nought to rounding move under
        # Adam by round-off alone: left out of the change
        moved = [n for n in first if first[n] >= 1e-3 * med_g]
        g, c = gaps(out["first_grad"], first, med_g, list(first)), \
            gaps(out["change"], change, med_c, moved)
        crop = target = 0.0
        for (x, tg, w), (rx, rt, rw, _) in zip(out["batches"], data):
            crop = max(crop, float((x - rx).abs().max()))
            target = max(target, float((tg - rt).abs().max()),
                         float((w - rw).abs().max()))
        loss = [abs(p - r) / abs(r) for p, r in zip(out["losses"], losses)]
        detail = {"losses": [out["losses"], losses], "grad_top": g[:3],
                  "change_top": c[:3], "left_out": len(first) - len(moved),
                  "crop": crop, "target": target}
        return [{"detail": detail, "loss": loss[0],
                 "loss_all_steps": max(loss), "grad_norm": g[0][0],
                 "change_norm": float(np.median([v for v, _ in c])),
                 "change_worst": c[0][0]}]


def setup(ctx):
    return TrainJob(ctx)
