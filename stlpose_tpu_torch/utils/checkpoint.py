"""Checkpointing: torch files of the whole train bundle.

Port of ``stlpose_tpu/utils/checkpoint.py`` under the same experiment-
directory contract: ``models/checkpoint_epoch_{N|final}`` (``models/
detector/`` for detectors) holds the model's state dict (weights and
BatchNorm statistics), the optimizer's (moments and learning rate) and
the step, as ``<name>.pt``, beside a ``<name>.meta.json`` with the epoch,
the learning rate and the scheduler's state. Loading has the reference's
three modes: full resume, weights only, and weights with the head left
at the template's (transfer to another keypoint or class count). A
detector checkpoint loads weights-only into a detector of any serving
flavor (``load_detector_checkpoint``).
"""

from __future__ import annotations

import json
import os
import re

import torch

from stlpose_tpu_torch.models.convert import (load_strict,
                                              load_torch_statedict,
                                              torch_statedict_to_port)
from stlpose_tpu_torch.models.quantize import apply_trunk_flavor
from stlpose_tpu_torch.train.optim import get_current_lr, set_current_lr
from stlpose_tpu_torch.train.state import PoseTrainState


def checkpoint_dir(exp_path: str, detector: bool = False) -> str:
    d = os.path.join(exp_path, "models")
    if detector:
        d = os.path.join(d, "detector")
    os.makedirs(d, exist_ok=True)
    return d


def checkpoint_path(exp_path: str, epoch, detector: bool = False) -> str:
    name = (f"checkpoint_epoch_{epoch}" if epoch != "final"
            else "checkpoint_epoch_final")
    return os.path.join(checkpoint_dir(exp_path, detector), name)


def save_checkpoint(state: PoseTrainState, exp_path: str, epoch,
                    scheduler=None, detector: bool = False,
                    finished: bool = False) -> str:
    """Save the bundle; ``epoch='final'`` or ``finished=True`` writes the
    final checkpoint's name. Tensors are saved from wherever they live and
    load onto any device. Returns the path without its suffix."""
    label = "final" if (finished or epoch == "final") else epoch
    path = checkpoint_path(exp_path, label, detector)
    torch.save({"model_state_dict": state.model.state_dict(),
                "optimizer_state_dict": state.optimizer.state_dict(),
                "step": int(state.step)}, path + ".pt")
    meta = {"epoch": int(epoch) if not isinstance(epoch, str) else epoch,
            "lr": get_current_lr(state.optimizer),
            "scheduler": (scheduler.state_dict()
                          if scheduler is not None else None)}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(template_state: PoseTrainState, exp_path: str, epoch,
                    scheduler=None, detector: bool = False,
                    only_model: bool = False, drop_head: bool = False,
                    head_paths: tuple = ("final_layer",)):
    """Restore a bundle into ``template_state`` in place.

    only_model: weights and BatchNorm statistics only (fine-tuning);
    drop_head: the modules named in ``head_paths`` keep the template's
    weights; otherwise (full resume) also the optimizer state, the step,
    the learning rate of the meta file and the scheduler.

    Returns (state, epoch), epoch 0 for ``only_model`` and "final"."""
    path = checkpoint_path(exp_path, epoch, detector)
    model = template_state.model
    dev = next(model.parameters()).device
    blob = torch.load(path + ".pt", map_location=dev, weights_only=True)
    weights = blob["model_state_dict"]
    if drop_head:
        own = model.state_dict()
        weights = {k: (own[k] if k.split(".")[0] in head_paths else v)
                   for k, v in weights.items()}
    model.load_state_dict(weights)
    if only_model:
        return template_state, 0

    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    template_state.optimizer.load_state_dict(blob["optimizer_state_dict"])
    template_state.step = int(blob["step"])
    if meta.get("lr") is not None:
        set_current_lr(template_state.optimizer, meta["lr"])
    if scheduler is not None and meta.get("scheduler"):
        scheduler.load_state_dict(meta["scheduler"])
    ep = meta.get("epoch", 0)
    return template_state, (0 if ep == "final" else int(ep))


def load_detector_checkpoint(detector, exp_path: str, epoch):
    """Load a detector checkpoint's weights into ``detector`` in place.

    The file holds a live-BatchNorm detector's f32 state dict; for a
    Faster R-CNN built with ``trunk_quant="folded"`` it is folded first
    (``models/quantize.py::apply_trunk_flavor``; an EfficientDet has no
    trunk flavor), then every entry is loaded strictly, rounded to the
    detector's dtype on the way in. Only the weights are read; the file's
    optimizer state is left."""
    path = checkpoint_path(exp_path, epoch, detector=True)
    blob = torch.load(path + ".pt", map_location="cpu", weights_only=True)
    sd = {k: v for k, v in blob["model_state_dict"].items()
          if not k.endswith("num_batches_tracked")}
    return load_strict(detector, apply_trunk_flavor(
        sd, getattr(detector, "trunk_quant", "none")))


def list_checkpoints(exp_path: str, detector: bool = False):
    out = []
    for name in sorted(os.listdir(checkpoint_dir(exp_path, detector))):
        m = re.fullmatch(r"checkpoint_epoch_(\w+)\.pt", name)
        if m:
            out.append(m.group(1))
    return out


def load_pretrained_variables(model, pth_path: str | None):
    """Load a reference-format HRNet ``.pth`` (``models/convert.py``'s name
    map) into ``model`` in place and return the state dict in the port's
    names; with no file at ``pth_path`` the model keeps its random
    initialisation and None is returned, as in the reference."""
    if not (pth_path and os.path.isfile(pth_path)):
        return None
    sd = torch_statedict_to_port(load_torch_statedict(pth_path))
    load_strict(model, sd)
    return sd
