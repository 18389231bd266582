"""Person-detector training and evaluation engines.

Port of ``stlpose_tpu/engines/detector_trainer.py`` (``DETECTOR_CONFIGS``,
``build_detector``, ``live_template_detector``, ``DetectorTrainer``,
``load_detector_pretrained``, ``evaluate_detector``,
``DetectorEvaluator``), the engines behind ``02_train_faster_rcnn.py``
and ``03_evaluate_faster_rcnn.py``, with the reference's semantics: the
loss is the summed torchvision-style loss dict with optional perceptual
weighting and a non-finite guard (``parallel/detector_steps.py``);
validation, before training in every epoch, is COCO bbox AP over the
valid pipeline, with a plateau scheduler on AP (mode max);
``detector_logs.json`` and checkpoints under ``models/detector/``; resume
from a checkpoint.

One device, ``device`` ("cuda" unless the caller asks for the CPU). The
serving flavors are arguments, where the JAX factory and detector read
``STLPOSE_DTYPE``, ``STLPOSE_FRCNN_TRUNK_QUANT`` and
``STLPOSE_PALLAS_ROI_INT8``; the scripts read those names and pass them
on. Training runs the live trunk in f32. ``DetectorEvaluator`` serves the
live and the folded trunk (``apply_trunk_flavor`` of the int8 flavors
waits for them). Both reference families build here: Faster R-CNN and
EfficientDet (``efficientdet`` with ``model.detector_type`` d0 or d3,
``efficientdet_d0``, ``efficientdet_d3``, ``efficientdet_tiny``), whose
only serving flavor is ``dtype``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import (CONFIG, EFFICIENTDET_D0,
                                      EFFICIENTDET_D3, EFFICIENTDET_TINY,
                                      FASTER_RCNN_TINY,
                                      FASTER_RCNN_TORCHVISION_PARITY,
                                      FasterRCNNConfig)
from stlpose_tpu_torch.data.coco_api import coco_from_dataset
from stlpose_tpu_torch.data.loaders import get_detection_dataset
from stlpose_tpu_torch.eval.submission import compute_detection_ap
from stlpose_tpu_torch.models.convert import (load_strict,
                                              load_torch_statedict)
from stlpose_tpu_torch.models.convert_detector import (
    torch_efficientdet_to_port, torch_fasterrcnn_to_port)
from stlpose_tpu_torch.models.efficientdet import EfficientDet
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.quantize import apply_trunk_flavor
from stlpose_tpu_torch.parallel.detector_steps import (
    make_detector_predict, make_detector_train_step)
from stlpose_tpu_torch.parallel.steps import MetricAccumulator
from stlpose_tpu_torch.train.loss import load_perceptual_loss_dict
from stlpose_tpu_torch.train.optim import (build_scheduler, get_current_lr,
                                           set_current_lr)
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_detector_checkpoint,
                                                save_checkpoint)
from stlpose_tpu_torch.utils.experiment import (create_detector_logs,
                                                load_detector_logs,
                                                load_experiment_parameters,
                                                save_evaluation_stats,
                                                update_detector_logs)
from stlpose_tpu_torch.utils.logger import print_

DETECTOR_CONFIGS = {
    # the serving budgets (pre/post NMS 500/256, 64 detections an image)
    "faster_rcnn": FasterRCNNConfig(),
    "faster_rcnn_tiny": FASTER_RCNN_TINY,
    # torchvision's budgets, for AP-parity runs
    "faster_rcnn_torchvision_parity": FASTER_RCNN_TORCHVISION_PARITY,
    # the reference's second family: d0 by default, d3 by detector_type
    "efficientdet": EFFICIENTDET_D0,
    "efficientdet_d0": EFFICIENTDET_D0,
    "efficientdet_d3": EFFICIENTDET_D3,
    "efficientdet_tiny": EFFICIENTDET_TINY,
}


def build_detector(exp_data: dict, config_name: str | None = None, *,
                   dtype=torch.float32, trunk_quant: str = "none",
                   roi_patch_quant: bool = False, device="cuda"):
    """(detector, config) for ``config_name``, or the experiment's
    ``model.detector_name`` (with ``model.detector_type`` d0/d3 naming an
    EfficientDet), built on ``device`` in the given flavor with the
    default initialisation of its modules. ``trunk_quant`` and
    ``roi_patch_quant`` are Faster R-CNN flavors: EfficientDet has no
    ResNet trunk and no RoIAlign, and refuses them."""
    name = config_name or exp_data["model"].get("detector_name",
                                                "faster_rcnn")
    det_type = exp_data["model"].get("detector_type", "")
    if name == "efficientdet" and det_type in ("d0", "d3"):
        name = f"efficientdet_{det_type}"
    if name not in DETECTOR_CONFIGS:
        raise ValueError(f"Detector '{name}' not supported; available: "
                         f"{list(DETECTOR_CONFIGS)}")
    cfg = DETECTOR_CONFIGS[name]
    if isinstance(cfg, FasterRCNNConfig):
        return FasterRCNN(cfg, device, dtype, roi_patch_quant,
                          trunk_quant), cfg
    if trunk_quant != "none" or roi_patch_quant:
        raise ValueError(
            f"Detector '{name}': trunk_quant={trunk_quant!r} and "
            f"roi_patch_quant={roi_patch_quant!r} are Faster R-CNN flavors; "
            "EfficientDet serves only in its dtype")
    return EfficientDet(cfg, device, dtype), cfg


def live_template_detector(exp_data: dict, detector_config=None,
                           device="cuda"):
    """``build_detector``'s (detector, config) with the live f32 trunk,
    its weights from the experiment's seed: checkpoints hold live-BN
    weights, so they are restored into this template even when serving
    wants another flavor."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(CONFIG["random_seed"])
        return build_detector(exp_data, detector_config, device=device)


def _detection_pipeline(exp_data, det_cfg, split, **kw):
    exp = {**exp_data, "dataset": {**exp_data["dataset"],
                                   "image_size": det_cfg.image_size}}
    return get_detection_dataset(exp, split, **kw)


def _device_batch(batch, device) -> dict:
    """The train step's inputs of a pipeline batch, on ``device``: the
    image (a host array, or the stylizer's device tensor) and the padded
    targets."""
    return {k: torch.as_tensor(batch[k], device=device)
            for k in ("image", "boxes", "labels", "box_mask",
                      "perceptual_loss")}


class DetectorTrainer:
    """Engine behind 02_train_faster_rcnn.py, on ``device``."""

    def __init__(self, exp_path: str, checkpoint=None,
                 resume_training: bool = False, dataset_name=None,
                 data_path=None, num_workers=None,
                 use_perceptual_loss: bool = False,
                 detector_config: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.exp_path = exp_path
        self.exp_data = load_experiment_parameters(exp_path)
        if dataset_name:
            self.exp_data["dataset"]["dataset_name"] = dataset_name
        self.checkpoint = checkpoint
        self.resume_training = resume_training
        self.data_path = data_path
        self.num_workers = num_workers
        self.use_perceptual_loss = use_perceptual_loss
        self.detector_config = detector_config
        self.cur_epoch = 0

    def load_dataset(self):
        """The detector (live f32 trunk, weights from the experiment's
        seed) and the train and valid detection pipelines at its canvas
        size."""
        ploss = None
        try:
            ploss = load_perceptual_loss_dict(
                self.exp_data, CONFIG["paths"]["dict_path"],
                self.use_perceptual_loss)
        except FileNotFoundError as e:
            print_(str(e), type="warning")
        self.detector, self.det_cfg = live_template_detector(
            self.exp_data, self.detector_config, self.device)
        kw = dict(num_workers=self.num_workers, data_path=self.data_path,
                  device=self.device)
        self.train_pipe = _detection_pipeline(
            self.exp_data, self.det_cfg, "train",
            shuffle=self.exp_data["dataset"].get("shuffle_train", False),
            perceptual_loss_dict=ploss, **kw)
        self.valid_pipe = _detection_pipeline(self.exp_data, self.det_cfg,
                                              "valid", **kw)

    def setup_model(self, pretrained: str | None = None):
        """The torchvision ``.pth`` at ``pretrained`` (if there is one),
        the optimizer and scheduler, the checkpoint (weights only, or
        everything with ``resume_training``), the steps and the sampling
        generator."""
        if load_detector_pretrained(self.detector, pretrained) is not None:
            print_(f"Loaded pretrained detector weights from {pretrained}")
        self.state = create_train_state(self.detector, self.exp_data)
        self.scheduler = build_scheduler(self.exp_data)
        if self.checkpoint is not None:
            self.state, epoch = load_checkpoint(
                self.state, self.exp_path, self.checkpoint,
                scheduler=self.scheduler if self.resume_training else None,
                detector=True, only_model=not self.resume_training)
            if self.resume_training:
                self.cur_epoch = epoch
                print_(f"Resuming detector training from epoch {epoch}")

        perceptual_cfg = None
        if (self.exp_data["dataset"]["dataset_name"] == "styled_coco"
                and (self.use_perceptual_loss
                     or self.exp_data["training"].get("perceptual_loss"))):
            perceptual_cfg = {**self.exp_data, "training": {
                **self.exp_data["training"], "perceptual_loss": True}}
        self.train_step = make_detector_train_step(perceptual_cfg)
        self.predict = make_detector_predict(self.detector)
        self.generator = torch.Generator(device=self.device).manual_seed(
            CONFIG["random_seed"] + 1)

    # ------------------------------------------------------------ epochs
    def train_epoch(self, epoch: int) -> float:
        acc = MetricAccumulator(finite_only=("loss",))
        for batch in self.train_pipe:
            metrics = self.train_step(self.state,
                                      _device_batch(batch, self.device),
                                      self.generator)
            acc.update(metrics)                 # device-side; no host sync
        stats = acc.fetch()                     # one fetch per train epoch
        # nan when no batch gave a finite loss, as the reference returns
        # after skipping every batch
        loss = stats["loss_mean"] if stats.get("loss_n") else float("nan")
        print_(f"Detector train loss: {loss}")
        return loss

    def validation_epoch(self, epoch: int, limit: int | None = None
                         ) -> float:
        """COCO bbox AP over the valid pipeline."""
        ap = evaluate_detector(self.predict, self.valid_pipe, self.device,
                               limit=limit)
        print_(f"Detector valid AP: {ap[0]:.4f}")
        return float(ap[0])

    def training_loop(self):
        exp = self.exp_data
        num_epochs = exp["training"]["num_epochs"]
        save_freq = exp["training"]["save_frequency"]
        if self.checkpoint is None or not self.resume_training:
            self.logs = create_detector_logs(self.exp_path)
        else:
            self.logs = load_detector_logs(self.exp_path)

        for epoch in range(self.cur_epoch, num_epochs):
            valid_ap = self.validation_epoch(epoch)
            train_loss = self.train_epoch(epoch)
            if self.scheduler is not None:
                lr = get_current_lr(self.state.optimizer)
                new_lr = self.scheduler.step(valid_ap, lr)  # mode max on AP
                if new_lr != lr:
                    print_(f"LR {lr} -> {new_lr}")
                    set_current_lr(self.state.optimizer, new_lr)
            update_detector_logs(self.exp_path, self.logs, train_loss,
                                 valid_ap)
            if epoch % save_freq == 0:
                save_checkpoint(self.state, self.exp_path, epoch,
                                scheduler=self.scheduler, detector=True)
        save_checkpoint(self.state, self.exp_path, num_epochs,
                        scheduler=self.scheduler, detector=True,
                        finished=True)


def load_detector_pretrained(detector, pth_path: str | None):
    """Load a pretrained detector ``.pth`` into ``detector`` in place, by
    family: a torchvision fasterrcnn_resnet50_fpn state dict (the
    reference seeds from torchvision's COCO-pretrained detector) or a
    zylo117-layout efficientdet-d{0,3} one (its multiclass header sliced
    to the person class). Returns the state dict in the port's names;
    None when no file is at ``pth_path``."""
    if not pth_path or not os.path.isfile(pth_path):
        return None
    state = load_torch_statedict(pth_path)
    if isinstance(detector, EfficientDet):
        sd = torch_efficientdet_to_port(
            state, num_classes=detector.config.num_classes)
    else:
        sd = torch_fasterrcnn_to_port(
            state, roi_channels=detector.config.fpn_channels)
    load_strict(detector, sd)
    return sd


def evaluate_detector(predict, pipe, device, limit: int | None = None,
                      score_thr: float = 0.0):
    """Detections over a pipeline and their COCO bbox AP (12 stats)
    against the pipeline's own ground truth, built in memory; all -1 when
    nothing was detected."""
    gt_samples, results = [], []
    for bi, batch in enumerate(pipe):
        if limit is not None and bi >= limit:
            break
        dets = predict(torch.as_tensor(batch["image"], device=device))
        dets = {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy() for k, v in dets.items()}
        for i in range(batch["n_valid"]):
            img_id = int(batch["image_id"][i])
            scale = float(batch["scale"][i])
            m = batch["box_mask"][i].astype(bool)
            gt_samples.append({
                "image_id": img_id,
                "boxes": batch["boxes"][i][m] / scale,
                "labels": batch["labels"][i][m].tolist(),
            })
            valid = dets["valid"][i] & (dets["scores"][i] > score_thr)
            for j in np.nonzero(valid)[0]:
                x1, y1, x2, y2 = dets["boxes"][i, j] / scale
                results.append({
                    "image_id": img_id,
                    "category_id": int(dets["labels"][i, j]),
                    "bbox": [float(x1), float(y1), float(x2 - x1),
                             float(y2 - y1)],
                    "score": float(dets["scores"][i, j]),
                })
    if not results:
        return np.full(12, -1.0)
    gt = coco_from_dataset(gt_samples,
                           categories=[{"id": 1, "name": "person"}])
    return compute_detection_ap(results, gt)


class DetectorEvaluator:
    """Engine behind 03_evaluate_faster_rcnn.py, on ``device``, in the
    serving flavor given by ``dtype``, ``trunk_quant`` ("none" or
    "folded") and ``roi_patch_quant``."""

    def __init__(self, exp_path: str, checkpoint=None, dataset_name=None,
                 data_path=None, num_workers=None,
                 detector_config: str | None = None, dtype=torch.float32,
                 trunk_quant: str = "none", roi_patch_quant: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.exp_path = exp_path
        self.exp_data = load_experiment_parameters(exp_path)
        if dataset_name:
            self.exp_data["dataset"]["dataset_name"] = dataset_name
        self.checkpoint = checkpoint
        self.data_path = data_path
        self.num_workers = num_workers
        self.detector_config = detector_config
        self.flavor = dict(dtype=dtype, trunk_quant=trunk_quant,
                           roi_patch_quant=roi_patch_quant)

    def setup(self):
        """The live template (seeded weights, then the checkpoint's), the
        serving detector made from it, and the valid pipeline."""
        template, self.det_cfg = live_template_detector(
            self.exp_data, self.detector_config, self.device)
        if self.checkpoint is not None:
            load_detector_checkpoint(template, self.exp_path,
                                     self.checkpoint)
        if self.flavor == dict(dtype=torch.float32, trunk_quant="none",
                               roi_patch_quant=False):
            self.detector = template
        else:
            self.detector, _ = build_detector(
                self.exp_data, self.detector_config, device=self.device,
                **self.flavor)
            sd = {k: v for k, v in template.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
            load_strict(self.detector,
                        apply_trunk_flavor(sd, self.flavor["trunk_quant"]))
        self.pipe = _detection_pipeline(
            self.exp_data, self.det_cfg, "valid",
            num_workers=self.num_workers, data_path=self.data_path,
            device=self.device)
        self.predict = make_detector_predict(self.detector)

    def evaluate(self, save_stats: bool = True):
        stats = evaluate_detector(self.predict, self.pipe, self.device)
        if save_stats:
            save_evaluation_stats(
                self.exp_path, stats, detector=True,
                dataset_name=self.exp_data["dataset"]["dataset_name"],
                checkpoint=str(self.checkpoint),
                alpha=self.exp_data["dataset"].get("alpha"),
                styles=self.exp_data["dataset"].get("styles"))
        return stats
