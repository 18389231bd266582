"""HRNet fine-tuning engine.

Port of ``stlpose_tpu/engines/trainer.py``, the engine behind
``02_train.py``, with the reference's semantics: validation runs before
training in every epoch, on max(1, len(valid) // 5) batches; Plateau or
Step scheduling on the validation loss; ``training_logs.json``, the loss
and accuracy plots and TensorBoard scalars each epoch (no writer without
tensorboardX, no plots without matplotlib); a checkpoint every
``save_frequency`` epochs and a final one; resume from a checkpoint
(epoch, step, optimizer, learning rate, scheduler); ``STLPOSE_PROFILE``
traces the first train epoch. Metrics stay on the device and are fetched
once per epoch or logging window.

One device, ``device`` ("cuda" unless the caller asks for the CPU), and
the compute ``dtype`` as an argument (the reference reads
``STLPOSE_DTYPE``; the scripts read it and pass it on). Parameters,
gradients and the optimizer's moments are f32 in either dtype: with bf16
each convolution runs on a bf16 cast of its f32 weight, and BatchNorm and
the loss stay f32, as in the JAX package.
"""

from __future__ import annotations

import itertools
import os

import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import CONFIG, get_hrnet_config
from stlpose_tpu_torch.data.loaders import load_dataset
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.parallel.steps import (MetricAccumulator,
                                              make_eval_step,
                                              make_train_step)
from stlpose_tpu_torch.train.loss import load_perceptual_loss_dict
from stlpose_tpu_torch.train.optim import (build_scheduler, get_current_lr,
                                           set_current_lr)
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_pretrained_variables,
                                                save_checkpoint)
from stlpose_tpu_torch.utils.experiment import (create_train_logs,
                                                load_experiment_parameters,
                                                load_train_logs,
                                                update_train_logs)
from stlpose_tpu_torch.utils.logger import print_
from stlpose_tpu_torch.utils.profiling import StepTimer, save_timing, trace


def _epoch_means(stats: dict) -> tuple[float, float]:
    """(mean loss, PCK) of a fetched accumulator."""
    loss = stats.get("loss_mean", 0.0)
    pck = (stats.get("pck_hit_sum", 0.0) / stats["pck_cnt_sum"]
           if stats.get("pck_cnt_sum") else 0.0)
    return loss, pck


class PoseTrainer:
    """Engine behind 02_train.py, on ``device`` in compute ``dtype``."""

    def __init__(self, exp_path: str, checkpoint=None,
                 resume_training: bool = False, dataset_name=None,
                 data_path=None, num_workers=None, use_perceptual_loss=False,
                 make_plots: bool = True, dtype=torch.float32,
                 device="cuda"):
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
        self.make_plots = make_plots
        self.dtype = dtype
        self.cur_epoch = 0
        self.iterations = 0
        self.writer = self._make_writer()

    def _make_writer(self):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(os.path.join(self.exp_path, "tboard_logs"))

    # ------------------------------------------------------------- setup
    def load_dataset(self):
        ploss = None
        try:
            ploss = load_perceptual_loss_dict(
                self.exp_data, CONFIG["paths"]["dict_path"],
                self.use_perceptual_loss)
        except FileNotFoundError as e:
            print_(str(e), type="warning")
        self.train_pipe, self.valid_pipe = load_dataset(
            self.exp_data,
            shuffle_train=self.exp_data["dataset"].get("shuffle_train", False),
            perceptual_loss_dict=ploss, data_path=self.data_path,
            num_workers=self.num_workers, device=self.device)

    def setup_model(self, config_name: str = "w32_256x192",
                    pretrained: str | None = "default"):
        """HRNet with f32 parameters in the compute dtype (random init from
        the experiment seed, then the ``.pth`` at ``pretrained`` if there
        is one), its optimizer and scheduler, the checkpoint (weights
        only, or everything with ``resume_training``) and the steps."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(CONFIG["random_seed"])
            self.model = PoseHighResolutionNet(
                get_hrnet_config(config_name), self.device, self.dtype,
                param_dtype=torch.float32)
        if pretrained == "default":
            pretrained = os.path.join(CONFIG["paths"]["pretrained_path"],
                                      "HRnet", "pose_hrnet_w32_256x192.pth")
        if load_pretrained_variables(self.model, pretrained) is not None:
            print_(f"Loaded pretrained weights from {pretrained}")
        self.state = create_train_state(self.model, self.exp_data)
        self.scheduler = build_scheduler(self.exp_data)

        if self.checkpoint is not None:
            self.state, epoch = load_checkpoint(
                self.state, self.exp_path, self.checkpoint,
                scheduler=self.scheduler if self.resume_training else None,
                only_model=not self.resume_training)
            if self.resume_training:
                self.cur_epoch = epoch
                print_(f"Resuming training from epoch {epoch}")

        perceptual_cfg = None
        if (self.exp_data["dataset"]["dataset_name"] == "styled_coco"
                and (self.use_perceptual_loss
                     or self.exp_data["training"].get("perceptual_loss"))):
            perceptual_cfg = {**self.exp_data, "training": {
                **self.exp_data["training"], "perceptual_loss": True}}
        self.train_step = make_train_step(perceptual_cfg=perceptual_cfg)
        self.eval_step = make_eval_step()

    # ------------------------------------------------------------ epochs
    def _run_valid_epoch(self, epoch: int) -> tuple[float, float]:
        acc = MetricAccumulator()
        limit = max(1, len(self.valid_pipe) // 5)   # 1/5 of the val loader
        for batch in itertools.islice(self.valid_pipe, limit):
            _, metrics = self.eval_step(self.state, batch)
            acc.update(metrics)                 # device-side; no host sync
        loss, pck = _epoch_means(acc.fetch())   # one fetch per valid epoch
        print_(f"Valid Loss: {loss}")
        print_(f"Valid Accuracy: {pck}")
        return loss, pck

    def _run_train_epoch(self, epoch: int) -> tuple[float, float]:
        acc = MetricAccumulator()
        timer = StepTimer()
        log_freq = self.exp_data["training"].get("log_frequency", 100)
        prev = {"n": 0.0, "loss_sum": 0.0}       # last fetched window
        for batch in self.train_pipe:
            metrics = self.train_step(self.state, self._step_view(batch))
            timer.tick(batch["image"].shape[0])
            acc.update(metrics)                 # device-side; no host sync
            self.iterations += 1
            if self.writer is not None and self.iterations % log_freq == 0:
                # one fetch per logging window: the window's mean from the
                # accumulator's delta
                snap = acc.fetch()
                dn = snap["n"] - prev["n"]
                if dn > 0:
                    self.writer.add_scalar(
                        "pose_train/loss",
                        (snap["loss_sum"] - prev["loss_sum"]) / dn,
                        global_step=self.iterations)
                prev = snap
        loss, pck = _epoch_means(acc.fetch())   # one fetch per train epoch
        save_timing(self.exp_path, "train_epoch", timer.stats())
        print_(f"Train Loss: {loss}  "
               f"({timer.stats()['examples_per_sec']} ex/s)")
        print_(f"Train Accuracy: {pck}")
        return loss, pck

    def _step_view(self, batch):
        """The train step's inputs: the batch's device tensors and its
        per-sample perceptual losses, uploaded from the host."""
        return {"image": batch["image"], "target": batch["target"],
                "target_weight": batch["target_weight"],
                "perceptual_loss": torch.as_tensor(batch["perceptual_loss"],
                                                   device=self.device)}

    # -------------------------------------------------------------- loop
    def training_loop(self):
        exp = self.exp_data
        num_epochs = exp["training"]["num_epochs"]
        save_freq = exp["training"]["save_frequency"]

        if self.checkpoint is None or not self.resume_training:
            self.logs = create_train_logs(self.exp_path)
        else:
            self.logs = load_train_logs(self.exp_path)

        profile_dir = os.environ.get("STLPOSE_PROFILE")
        for epoch in range(self.cur_epoch, num_epochs):
            valid_loss, valid_acc = self._run_valid_epoch(epoch)
            # a torch.profiler trace of the first train epoch
            with trace(profile_dir, enabled=bool(profile_dir)
                       and epoch == self.cur_epoch, device=self.device):
                train_loss, train_acc = self._run_train_epoch(epoch)

            if self.scheduler is not None:
                lr = get_current_lr(self.state.optimizer)
                new_lr = self.scheduler.step(valid_loss, lr)
                if new_lr != lr:
                    print_(f"LR {lr} -> {new_lr}")
                    set_current_lr(self.state.optimizer, new_lr)

            update_train_logs(self.exp_path, self.logs, self.iterations,
                              train_loss=train_loss, valid_loss=valid_loss,
                              train_acc=train_acc, valid_acc=valid_acc,
                              make_plots=self.make_plots)
            if epoch % save_freq == 0:
                print_("Saving model checkpoint")
                save_checkpoint(self.state, self.exp_path, epoch,
                                scheduler=self.scheduler)
            if self.writer is not None:
                self.writer.add_scalars("pose_results/COMB_loss", {
                    "train_loss": train_loss, "eval_loss": valid_loss},
                    epoch + 1)
                self.writer.add_scalars("pose_results/COMB_acc", {
                    "train_acc": train_acc, "eval_acc": valid_acc},
                    epoch + 1)

        print_("Finished training procedure")
        save_checkpoint(self.state, self.exp_path, num_epochs,
                        scheduler=self.scheduler, finished=True)
        if self.writer is not None:
            self.writer.flush()
