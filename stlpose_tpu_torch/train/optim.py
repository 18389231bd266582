"""Optimizers and learning-rate schedulers.

Port of ``stlpose_tpu/train/optim.py``. Adam with optax's defaults
(betas 0.9/0.999, eps 1e-8 added to sqrt of the bias-corrected second
moment) or SGD with weight decay 5e-4 added to the gradient before
momentum/nesterov, optax's chain order; both are ``torch.optim``'s, which
compute the same updates. The learning rate sits in the optimizer's
param groups, so the host-side schedulers change it between epochs with
nothing rebuilt.
"""

from __future__ import annotations

import dataclasses

import torch


def build_optimizer(exp_data: dict, params) -> torch.optim.Optimizer:
    """Adam or SGD over ``params``, as the experiment's training group
    says."""
    t = exp_data["training"]
    lr = float(t["learning_rate"])
    if t.get("optimizer", "adam") == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.SGD(params, lr=lr,
                           momentum=float(t.get("momentum", 0.9)),
                           nesterov=bool(t.get("nesterov", False)),
                           weight_decay=5e-4)


def get_current_lr(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_current_lr(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau(mode="max") with torch semantics (factor,
    patience, min_lr)."""
    factor: float
    patience: int
    min_lr: float = 1e-8
    mode: str = "max"
    best: float = None
    num_bad: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed the epoch's validation metric; returns the (possibly
        reduced) learning rate."""
        better = (self.best is None or
                  (metric > self.best if self.mode == "max"
                   else metric < self.best))
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad = 0
        return lr

    def state_dict(self):
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.best = d.get("best")
        self.num_bad = int(d.get("num_bad", 0))


@dataclasses.dataclass
class StepScheduler:
    """StepLR(gamma=lr_factor, step_size=patience)."""
    gamma: float
    step_size: int
    epoch: int = 0

    def step(self, metric: float, lr: float) -> float:
        self.epoch += 1
        if self.epoch % self.step_size == 0:
            lr = lr * self.gamma
        return lr

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, d):
        self.epoch = int(d.get("epoch", 0))


def build_scheduler(exp_data: dict):
    """Plateau, step or no scheduler, as the training group says."""
    t = exp_data["training"]
    kind = t.get("scheduler", "plateau")
    if kind == "plateau":
        return PlateauScheduler(factor=float(t["learning_rate_factor"]),
                                patience=int(t["patience"]))
    if kind == "step":
        return StepScheduler(gamma=float(t["learning_rate_factor"]),
                             step_size=int(t["patience"]))
    return None
