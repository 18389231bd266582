"""HRNet COCO evaluation engine.

Port of ``stlpose_tpu/engines/evaluator.py``, the engine behind
``03_evaluate.py``: the experiment's valid records -> device-warp batches
(K4) -> one flip-TTA forward of the doubled batch -> loss, PCK and decode
(K1) in one step (``parallel/steps.py::make_eval_decode_step``) -> host
rescoring and OKS-NMS -> submission file -> COCO keypoint AP over the
evaluated images -> stats JSON keyed by checkpoint.

Batch k's keypoints come to the host only after batch k+1's step is
enqueued, and the metric sums are fetched once, after the last batch.

On a data-parallel mesh (``parallel/mesh.py::get_mesh``: every rank of
the process group) each rank's loader makes the same global batch, padded
to a multiple of the mesh, and warps and evaluates its own rows; the
decoded keypoints are gathered onto every rank (``all_gather_host``) and
the padding dropped; rank 0 writes the submission and scores it, and the
stats are broadcast, so every rank returns the same vector. The
compute dtype is the constructor's ``dtype`` (the reference reads the
``STLPOSE_DTYPE`` environment variable); BatchNorm and the heatmaps stay
f32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import CONFIG, get_hrnet_config
from stlpose_tpu_torch.data.coco_api import COCO
from stlpose_tpu_torch.data.loaders import load_dataset
from stlpose_tpu_torch.eval.submission import (compute_precision,
                                               generate_submission)
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.ops.affine import get_affine_matrix_np
from stlpose_tpu_torch.ops.pose_entries import unnormalize
from stlpose_tpu_torch.parallel.distributed import (all_gather_host,
                                                    broadcast_host,
                                                    process_index)
from stlpose_tpu_torch.parallel.mesh import get_mesh, shard_batch
from stlpose_tpu_torch.parallel.steps import (MetricAccumulator,
                                              make_eval_decode_step)
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_pretrained_variables)
from stlpose_tpu_torch.utils.experiment import (load_experiment_parameters,
                                                reset_predictions_file,
                                                save_evaluation_stats)
from stlpose_tpu_torch.utils.logger import print_
from stlpose_tpu_torch.utils.visualization import draw_pose


def records_to_coco_gt(records):
    """An in-memory COCO keypoint GT from pose records, for datasets with no
    annotation file in COCO layout: one annotation per record, its box
    from the crop geometry (center and scale in units of 200 px)."""
    images, anns = [], []
    seen = set()
    for i, rec in enumerate(records):
        if rec.image_id not in seen:
            seen.add(rec.image_id)
            images.append({"id": int(rec.image_id), "height": 10000,
                           "width": 10000})
        kp = np.concatenate(
            [rec.joints,
             np.where(rec.joints_vis[:, None] > 0, 2.0, 0.0)], axis=1)
        w = rec.scale[0] * 200.0
        h = rec.scale[1] * 200.0
        x, y = rec.center[0] - w / 2, rec.center[1] - h / 2
        anns.append({"id": i + 1, "image_id": int(rec.image_id),
                     "category_id": 1,
                     "keypoints": kp.reshape(-1).tolist(),
                     "num_keypoints": int((rec.joints_vis > 0).sum()),
                     "bbox": [float(x), float(y), float(w), float(h)],
                     "area": float(w * h), "iscrowd": 0})
    return COCO({"images": images, "annotations": anns,
                 "categories": [{"id": 1, "name": "person"}]})


def device_batch(batch, device, mesh=None):
    """The eval step's inputs from a pipeline batch: the device tensors,
    with the host metadata's centres and scales uploaded (on a ``mesh``,
    this rank's rows)."""
    out = {k: batch[k] for k in ("image", "target", "target_weight")}
    out.update(shard_batch(mesh, {k: batch[k] for k in ("center", "scale")},
                           device))
    return out


class PoseEvaluator:
    """Engine behind 03_evaluate.py, on ``device`` ("cuda" unless the
    caller asks for the CPU) in compute ``dtype``."""

    def __init__(self, exp_path: str, checkpoint=None, dataset_name=None,
                 data_path=None, num_workers=None, flip: bool = True,
                 save_results: bool = True, save_visualizations: bool = False,
                 max_visualizations: int = 16, dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.exp_path = exp_path
        self.exp_data = load_experiment_parameters(exp_path)
        if dataset_name:
            self.exp_data["dataset"]["dataset_name"] = dataset_name
        self.checkpoint = checkpoint
        self.data_path = data_path
        self.num_workers = num_workers
        self.flip = flip
        self.save_results = save_results
        self.save_visualizations = save_visualizations
        self.max_visualizations = max_visualizations
        self._n_vis = 0
        self.dtype = dtype
        self.preds_file = os.path.join(exp_path,
                                       CONFIG["paths"]["submission"])

    def setup_model_dataset(self, config_name: str = "w32_256x192",
                            pretrained: str | None = "default"):
        self.mesh = get_mesh(device=self.device)
        _, self.valid_pipe = load_dataset(
            self.exp_data, train=False, data_path=self.data_path,
            num_workers=self.num_workers, device=self.device,
            pad_multiple=self.mesh.size(), mesh=self.mesh)
        # random init from the experiment seed, without touching the
        # caller's generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(CONFIG["random_seed"])
            self.model = PoseHighResolutionNet(get_hrnet_config(config_name),
                                               self.device, self.dtype)
        if pretrained == "default":
            pretrained = os.path.join(CONFIG["paths"]["pretrained_path"],
                                      "HRnet", "pose_hrnet_w32_256x192.pth")
        load_pretrained_variables(self.model, pretrained)
        self.state = create_train_state(self.model, self.exp_data)
        if self.checkpoint is not None:
            self.state, _ = load_checkpoint(self.state, self.exp_path,
                                            self.checkpoint, only_model=True)
        self.eval_decode = make_eval_decode_step(self.model,
                                                 flip_tta=self.flip,
                                                 mesh=self.mesh)

    def evaluate_model(self, labels_file: str | None = None,
                       write_every: int = 2000):
        """Full evaluation pass; returns the 10-stat keypoint AP vector."""
        exp = self.exp_data
        data_path = self.data_path or CONFIG["paths"]["data_path"]
        if labels_file is None:
            if exp["dataset"]["dataset_name"] in ("coco", "styled_coco"):
                labels_file = os.path.join(data_path, "annotations",
                                           "person_keypoints_val.json")
            else:
                labels_file = records_to_coco_gt(self.valid_pipe.records)
        rank0 = process_index() == 0
        if rank0:
            reset_predictions_file(self.exp_path)
        self._pending_host = ([], [], [])
        self._write_every = write_every

        acc = MetricAccumulator()
        pending = None
        for batch in self.valid_pipe:
            preds, metrics = self.eval_decode(device_batch(
                batch, self.device, self.mesh))
            acc.update(metrics)                 # device-side; no host sync
            if pending is not None:
                self.consume(*pending)
            pending = (preds, batch)
        if pending is not None:
            self.consume(*pending)
        if self._pending_host[2] and rank0:
            self._flush()

        stats = acc.fetch()                     # the one metrics fetch
        self.valid_loss = stats.get("loss_mean", 0.0)
        self.valid_acc = (stats.get("pck_hit_sum", 0.0) /
                          stats["pck_cnt_sum"]
                          if stats.get("pck_cnt_sum") else 0.0)
        print_(f"Eval Loss: {self.valid_loss}  PCK: {self.valid_acc}")

        stats = (compute_precision(self.preds_file, labels_file) if rank0
                 else None)
        stats = broadcast_host(stats)
        if self.save_results and rank0:
            save_evaluation_stats(
                self.exp_path, stats,
                dataset_name=exp["dataset"]["dataset_name"],
                checkpoint=str(self.checkpoint),
                alpha=exp["dataset"].get("alpha"),
                styles=exp["dataset"].get("styles"))
        return stats

    def consume(self, preds_dev, batch):
        """Host side of one batch: fetch its decoded keypoints (called after
        the next batch's step is enqueued, so the fetch overlaps that
        forward), keep them with their boxes and image ids, and write the
        submission every ``write_every`` persons. On a mesh the ranks'
        keypoints are gathered first, and rank 0 draws and writes."""
        all_preds, all_boxes, image_ids = self._pending_host
        n = batch["n_valid"]
        preds = all_gather_host(preds_dev.cpu().numpy())[:n]
        rank0 = process_index() == 0
        if self.save_visualizations and rank0 and \
                self._n_vis < self.max_visualizations:
            self._dump_visualizations(batch, preds)
        center, scale = batch["center"][:n], batch["scale"][:n]
        area = np.prod(scale * 200.0, axis=1)
        all_preds.append(preds)
        all_boxes.append(np.concatenate(
            [center, scale, area[:, None], batch["score"][:n, None]], axis=1))
        image_ids.extend(batch["image_id"][:n].tolist())
        if len(image_ids) >= self._write_every:
            if rank0:
                self._flush()
            self._pending_host = ([], [], [])

    def _dump_visualizations(self, batch, preds):
        """The predicted skeletons drawn over the un-normalised input crops
        (``plots/eval_examples/eval_<image_id>_<i>.png``), until
        ``max_visualizations`` crops are drawn."""
        out_dir = os.path.join(self.exp_path, "plots", "eval_examples")
        os.makedirs(out_dir, exist_ok=True)
        # on a mesh rank 0 holds the first rows of the batch's crops
        n = min(len(preds), self.max_visualizations - self._n_vis,
                batch["image"].shape[0])
        imgs = batch["image"][:n].float().cpu().numpy()
        for i in range(n):
            # image-space predictions into the crop
            mat = get_affine_matrix_np(batch["center"][i],
                                       batch["scale"][i], 0.0, (192, 256))
            pts = np.concatenate([preds[i, :, :2],
                                  np.ones((preds.shape[1], 1))], 1) @ mat.T
            pose = np.concatenate([pts, preds[i, :, 2:3]], axis=1)
            draw_pose(unnormalize(imgs[i]), pose,
                      savepath=os.path.join(
                          out_dir,
                          f"eval_{int(batch['image_id'][i])}_{i}.png"))
            self._n_vis += 1

    def _flush(self):
        all_preds, all_boxes, image_ids = self._pending_host
        ev = self.exp_data["evaluation"]
        generate_submission(
            np.concatenate(all_preds), np.concatenate(all_boxes), image_ids,
            self.preds_file, in_vis_thr=ev.get("in_vis_thr", 0.2),
            oks_thr=ev.get("oks_thr", 0.9))
        self._pending_host = ([], [], [])
