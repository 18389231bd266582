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
needs no input permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch.config import FasterRCNNConfig, HRNetConfig
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet

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
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    for key, _, arr in _flatten(variables.get("batch_stats", {}),
                                _STAT_LEAF):
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_jax_variables(module: torch.nn.Module, variables):
    """Load converted JAX variables into ``module``; every parameter and
    statistic must be matched one to one, with equal shapes."""
    sd = jax_variables_to_state_dict(variables)
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


def hrnet_from_jax(variables_np, config: HRNetConfig, device="cuda"):
    """A fresh ``PoseHighResolutionNet`` holding the JAX HRNet's weights."""
    return load_jax_variables(PoseHighResolutionNet(config, device),
                              variables_np)


def faster_rcnn_from_jax(variables_np, config: FasterRCNNConfig,
                         device="cuda"):
    """A fresh ``FasterRCNN`` holding the JAX detector's weights."""
    return load_jax_variables(FasterRCNN(config, device), variables_np)
