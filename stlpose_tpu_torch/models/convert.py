"""Carry weights of the JAX package's models into the port's modules.

The port's submodules repeat the Flax module tree's names, so a Flax path
``("stage2_m0", "branch0_block0", "cb1", "conv", "kernel")`` is the state
dict key ``stage2_m0.branch0_block0.cb1.conv.weight``; only layouts and
leaf names change:

  * conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in);
  * BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
    (batch_stats) -> ``weight``/``bias``/``running_mean``/``running_var``.

Counterpart of ``stlpose_tpu/models/convert.py`` (torch -> Flax names) and
``convert_detector.py`` in the other direction. The port's ``BoxHead``
flattens pooled features in the reference's (7, 7, C) order, so ``fc6``
needs no input permutation. ``train_state_from_jax`` carries a whole JAX
train state (weights, BatchNorm statistics, optimizer moments, step)
across, so a run continues a JAX run step for step. ``hrnet_from_jax``
and ``faster_rcnn_from_jax`` also build the serving flavors: they take
live-BatchNorm variables (folded here by ``models/quantize.py``) or
variables the JAX package already folded (no ``batch_stats``).
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch.config import FasterRCNNConfig, HRNetConfig
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.models.quantize import (apply_trunk_flavor,
                                               fold_batchnorms)
from stlpose_tpu_torch.train.optim import set_current_lr
from stlpose_tpu_torch.train.state import PoseTrainState, create_train_state

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, leaf_names, prefix=()):
    for k, v in tree.items():
        path = prefix + (k,)
        if hasattr(v, "items"):
            yield from _flatten(v, leaf_names, path)
        else:
            if k not in leaf_names:
                raise KeyError(f"unexpected Flax leaf {'/'.join(path)}")
            yield ".".join(path[:-1] + (leaf_names[k],)), k, np.asarray(v)


def jax_variables_to_state_dict(variables) -> dict:
    """{"params", "batch_stats"} of numpy arrays -> {name: float32 tensor}
    in the port's names and layouts."""
    out = {}
    for key, leaf, arr in _flatten(variables["params"], _PARAM_LEAF):
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    for key, _, arr in _flatten(variables.get("batch_stats", {}),
                                _STAT_LEAF):
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def load_strict(module: torch.nn.Module, sd):
    """Load the state dict ``sd`` into ``module``, every parameter and
    statistic matched one to one with equal shapes (values are rounded to
    the module's dtype on the way in)."""
    own = module.state_dict()
    expected = {k for k in own if not k.endswith("num_batches_tracked")}
    if set(sd) != expected:
        raise KeyError(f"weights do not match the module: missing "
                       f"{sorted(expected - set(sd))[:5]}, unexpected "
                       f"{sorted(set(sd) - expected)[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} vs module "
                             f"{tuple(own[k].shape)}")
        own[k] = v
    module.load_state_dict(own)
    return module


def _live_bn(variables_np):
    return bool(variables_np.get("batch_stats"))


def hrnet_from_jax(variables_np, config: HRNetConfig, device="cuda",
                   dtype=torch.float32, folded: bool = False):
    """A fresh ``PoseHighResolutionNet`` holding the JAX HRNet's weights;
    with ``folded``, live-BatchNorm variables are folded first."""
    sd = jax_variables_to_state_dict(variables_np)
    if folded and _live_bn(variables_np):
        sd = fold_batchnorms(sd)
    return load_strict(PoseHighResolutionNet(config, device, dtype, folded),
                       sd)


def faster_rcnn_from_jax(variables_np, config: FasterRCNNConfig,
                         device="cuda", dtype=torch.float32,
                         roi_patch_quant: bool = False,
                         trunk_quant: str = "none"):
    """A fresh ``FasterRCNN`` holding the JAX detector's weights; with
    ``trunk_quant="folded"``, live-BatchNorm variables are folded first."""
    sd = jax_variables_to_state_dict(variables_np)
    if _live_bn(variables_np):
        sd = apply_trunk_flavor(sd, trunk_quant)
    return load_strict(FasterRCNN(config, device, dtype, roi_patch_quant,
                                  trunk_quant), sd)


def _optax_leaf_state(opt_state, field):
    """The first state in optax's nested tuples that has ``field`` (``mu``
    for Adam's moments, ``trace`` for SGD's momentum)."""
    if hasattr(opt_state, field):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _optax_leaf_state(sub, field)
            if found is not None:
                return found
    inner = getattr(opt_state, "inner_state", None)
    return None if inner is None else _optax_leaf_state(inner, field)


def train_state_from_jax(state_np, config: HRNetConfig, exp_data: dict,
                         device="cuda") -> PoseTrainState:
    """A port train state continuing a JAX ``PoseTrainState`` given as
    numpy (``jax.device_get(state)``): params and batch_stats into HRNet,
    the injected learning rate, Adam's ``mu``/``nu`` and count (or SGD's
    momentum trace) into the optimizer, and the step."""
    model = hrnet_from_jax({"params": state_np.params,
                            "batch_stats": state_np.batch_stats},
                           config, device)
    state = create_train_state(model, exp_data)
    opt = state.optimizer
    hyper = getattr(state_np.opt_state, "hyperparams", {})
    if "learning_rate" in hyper:
        set_current_lr(opt, float(np.asarray(hyper["learning_rate"])))
    dev = next(model.parameters()).device
    named = dict(model.named_parameters())

    def as_port(tree):
        sd = jax_variables_to_state_dict({"params": tree})
        if set(sd) != set(named):
            raise KeyError("optimizer state does not match the model")
        return {k: v.to(dev) for k, v in sd.items()}

    adam = _optax_leaf_state(state_np.opt_state, "mu")
    sgd = _optax_leaf_state(state_np.opt_state, "trace")
    if isinstance(opt, torch.optim.Adam) and adam is not None:
        mu, nu = as_port(adam.mu), as_port(adam.nu)
        count = float(np.asarray(adam.count))
        for k, p in named.items():
            opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                            "exp_avg": mu[k], "exp_avg_sq": nu[k]}
    elif isinstance(opt, torch.optim.SGD) and sgd is not None:
        trace = as_port(sgd.trace)
        for k, p in named.items():
            opt.state[p] = {"momentum_buffer": trace[k]}
    else:
        raise ValueError(f"optimizer state {type(state_np.opt_state)} does "
                         f"not fit {type(opt).__name__}")
    state.step = int(np.asarray(state_np.step))
    return state
