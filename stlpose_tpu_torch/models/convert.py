"""Carry weights of the JAX package's models into the port's modules.

The port's submodules repeat the Flax module tree's names, so a Flax path
``("stage2_m0", "branch0_block0", "cb1", "conv", "kernel")`` is the state
dict key ``stage2_m0.branch0_block0.cb1.conv.weight``; only layouts and
leaf names change:

  * conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in);
  * BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
    (batch_stats) -> ``weight``/``bias``/``running_mean``/``running_var``;
  * an int8 ConvBN's leaves (the output of ``quantize_hrnet`` /
    ``quantize_frcnn_trunk``) keep their names: ``kernel_i8`` HWIO int8
    -> int8 in kernel K6's (C_out, Kpad) layout, ``sw``, ``sx``, ``bias``,
    ``zp``, ``qlo``, ``qhi`` as f32.

Counterpart of ``stlpose_tpu/models/convert.py`` (torch -> Flax names) and
``convert_detector.py`` in the other direction. ``load_torch_statedict``
and ``torch_statedict_to_port`` read an HRNet ``.pth`` in the reference
repository's names (``conv1``, ``layer1.0.downsample.1``,
``stage2.0.fuse_layers.1.0.0``, ...) through an own copy of the JAX
package's name map, ``_torch_key_to_path``. The port's ``BoxHead``
flattens pooled features in the reference's (7, 7, C) order, so ``fc6``
needs no input permutation. ``train_state_from_jax`` carries a whole JAX
train state (weights, BatchNorm statistics, optimizer moments, step)
across, so a run continues a JAX run step for step. ``hrnet_from_jax``
and ``faster_rcnn_from_jax`` also build the serving flavors: they take
live-BatchNorm variables (folded here by ``models/quantize.py``) or
variables the JAX package already folded (no ``batch_stats``), or the
JAX package's int8 variables for ``quant`` / ``trunk_quant`` "int8" and
"int8u".
``efficientdet_from_jax`` carries the EfficientDet tree across (its
BiFPN fusion weights are plain parameters, not Flax leaves of a layer).
``vgg_from_jax`` and ``adain_decoder_from_jax`` carry the style-transfer
networks across; ``adain_decoder_to_flax_params`` goes the other way, for
the decoder npz that both packages read.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from stlpose_tpu_torch.config import (EfficientDetConfig, FasterRCNNConfig,
                                      HRNetConfig)
from stlpose_tpu_torch.kernels.int8_conv import relayout_kernel_i8
from stlpose_tpu_torch.models.adain import AdaINDecoder
from stlpose_tpu_torch.models.efficientdet import EfficientDet
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.models.quantize import (flavored_state_dict,
                                               fold_batchnorms)
from stlpose_tpu_torch.models.vgg import VGG16Features
from stlpose_tpu_torch.train.optim import set_current_lr
from stlpose_tpu_torch.train.state import PoseTrainState, create_train_state

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               **{k: k for k in ("kernel_i8", "sw", "sx", "zp", "qlo",
                                 "qhi")}}
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
        if leaf == "kernel_i8":
            out[key] = relayout_kernel_i8(torch.from_numpy(
                np.array(arr, np.int8).transpose(3, 2, 0, 1)))
            continue
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


_BN_PARAM = {"weight": "scale", "bias": "bias"}
_BN_STAT = {"running_mean": "mean", "running_var": "var"}


def _torch_key_to_path(key: str):
    """One reference-format torch key -> (collection, Flax path), None for
    ``num_batches_tracked``; collection is "params" or "batch_stats"."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked":
        return None

    def convbn(prefix: Tuple[str, ...], kind: str):
        if kind == "conv":
            return ("params", prefix + ("conv", "kernel"))
        if leaf in _BN_PARAM:
            return ("params", prefix + ("bn", _BN_PARAM[leaf]))
        return ("batch_stats", prefix + ("bn", _BN_STAT[leaf]))

    # stem: conv1/bn1/conv2/bn2
    m = re.fullmatch(r"(conv|bn)([12])\.(\w+)", key)
    if m:
        return convbn((f"stem{m.group(2)}",), m.group(1))
    # layer1.{k}.{conv|bn}{q}.* and layer1.{k}.downsample.{0|1}.*
    m = re.fullmatch(r"layer1\.(\d+)\.(conv|bn)(\d)\.(\w+)", key)
    if m:
        return convbn((f"layer1_{m.group(1)}", f"cb{m.group(3)}"), m.group(2))
    m = re.fullmatch(r"layer1\.(\d+)\.downsample\.([01])\.(\w+)", key)
    if m:
        return convbn((f"layer1_{m.group(1)}", "down"),
                      "conv" if m.group(2) == "0" else "bn")
    # transition{t}.{i}.{0|1}.*   (aligned-branch conv+bn)
    m = re.fullmatch(r"transition(\d)\.(\d+)\.([01])\.(\w+)", key)
    if m:
        return convbn((f"transition{m.group(1)}_{m.group(2)}",),
                      "conv" if m.group(3) == "0" else "bn")
    # transition{t}.{i}.{j}.{0|1}.*  (new-branch downsample chain)
    m = re.fullmatch(r"transition(\d)\.(\d+)\.(\d+)\.([01])\.(\w+)", key)
    if m:
        return convbn(
            (f"transition{m.group(1)}_{m.group(2)}_{m.group(3)}",),
            "conv" if m.group(4) == "0" else "bn")
    # stage{s}.{m}.branches.{b}.{k}.{conv|bn}{q}.*
    m = re.fullmatch(r"stage(\d)\.(\d+)\.branches\.(\d+)\.(\d+)\."
                     r"(conv|bn)(\d)\.(\w+)", key)
    if m:
        s, mod, b, k, kind, q, _ = m.groups()
        return convbn((f"stage{s}_m{mod}", f"branch{b}_block{k}", f"cb{q}"),
                      kind)
    m = re.fullmatch(r"stage(\d)\.(\d+)\.branches\.(\d+)\.(\d+)\."
                     r"downsample\.([01])\.(\w+)", key)
    if m:
        s, mod, b, k, idx, _ = m.groups()
        return convbn((f"stage{s}_m{mod}", f"branch{b}_block{k}", "down"),
                      "conv" if idx == "0" else "bn")
    # stage{s}.{m}.fuse_layers.{i}.{j}.{0|1}.*  (up-fusion conv+bn)
    m = re.fullmatch(r"stage(\d)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\."
                     r"([01])\.(\w+)", key)
    if m:
        s, mod, i, j, idx, _ = m.groups()
        return convbn((f"stage{s}_m{mod}", f"fuse{i}_{j}"),
                      "conv" if idx == "0" else "bn")
    # stage{s}.{m}.fuse_layers.{i}.{j}.{k}.{0|1}.*  (down-fusion chain)
    m = re.fullmatch(r"stage(\d)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.(\d+)\."
                     r"([01])\.(\w+)", key)
    if m:
        s, mod, i, j, k, idx, _ = m.groups()
        return convbn((f"stage{s}_m{mod}", f"fuse{i}_{j}_{k}"),
                      "conv" if idx == "0" else "bn")
    # head
    if key == "final_layer.weight":
        return ("params", ("final_layer", "kernel"))
    if key == "final_layer.bias":
        return ("params", ("final_layer", "bias"))
    raise KeyError(f"Unrecognized torch state_dict key: {key}")


def load_torch_statedict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's HRNet weights on the CPU: a bare state dict or
    the reference's checkpoint bundle ``{"model_state_dict": ...}``, with
    any ``module.`` prefix of a DataParallel save removed. Tensors only
    (``weights_only``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k):
            v.detach() for k, v in blob.items()}


def torch_statedict_to_port(state) -> dict:
    """A reference-format HRNet state dict -> the port's names. Both sides
    are torch modules, so layouts stay; only names change (through the
    Flax path: ``stage2.0.branches.1.0.bn2.running_var`` ->
    ``stage2_m0.branch1_block0.cb2.bn.running_var``)."""
    leaf_names = {**_PARAM_LEAF, **_STAT_LEAF}
    out = {}
    for key, val in state.items():
        mapped = _torch_key_to_path(key)
        if mapped is None:
            continue
        _, path = mapped
        out[".".join(path[:-1] + (leaf_names[path[-1]],))] = \
            torch.as_tensor(val, dtype=torch.float32)
    return out


def _live_bn(variables_np):
    return bool(variables_np.get("batch_stats"))


def hrnet_from_jax(variables_np, config: HRNetConfig, device="cuda",
                   dtype=torch.float32, folded: bool = False,
                   quant: str = "none"):
    """A fresh ``PoseHighResolutionNet`` holding the JAX HRNet's weights;
    with ``folded``, live-BatchNorm variables are folded first; with
    ``quant`` "int8" / "int8u" (folded), the JAX package's quantized
    variables (``quantize_hrnet``) go in as they are."""
    sd = jax_variables_to_state_dict(variables_np)
    if folded and _live_bn(variables_np):
        sd = fold_batchnorms(sd)
    return load_strict(PoseHighResolutionNet(config, device, dtype, folded,
                                             quant=quant), sd)


def faster_rcnn_from_jax(variables_np, config: FasterRCNNConfig,
                         device="cuda", dtype=torch.float32,
                         roi_patch_quant: bool = False,
                         trunk_quant: str = "none", param_dtype=None):
    """A fresh ``FasterRCNN`` holding the JAX detector's weights (stored in
    ``param_dtype``, None: ``dtype``); with
    ``trunk_quant="folded"``, live-BatchNorm variables are folded first;
    with "int8" / "int8u", the variables are the JAX package's quantized
    ones (``quantize_frcnn_trunk``), which go in as they are."""
    sd = jax_variables_to_state_dict(variables_np)
    if _live_bn(variables_np) and trunk_quant == "folded":
        sd = flavored_state_dict(sd, trunk_quant)
    return load_strict(FasterRCNN(config, device, dtype, roi_patch_quant,
                                  trunk_quant, param_dtype), sd)


def efficientdet_from_jax(variables_np, config: EfficientDetConfig,
                          device="cuda", dtype=torch.float32,
                          param_dtype=None):
    """A fresh ``EfficientDet`` holding the JAX detector's parameters
    (stored in ``param_dtype``, None: ``dtype``) and BatchNorm
    statistics, strictly (no key missing, none left over). The
    BiFPN fusion weights (``bifpn_{l}/w_td_{i}``, ``w_bu_{i}``) are
    vectors held by the layer itself and go across as they are."""
    params, fusion = {}, {}
    for name, sub in variables_np["params"].items():
        if name.startswith("bifpn_"):
            params[name] = {k: v for k, v in sub.items()
                            if not k.startswith("w_")}
            fusion.update({f"{name}.{k}": torch.from_numpy(
                np.array(v, np.float32)) for k, v in sub.items()
                if k.startswith("w_")})
        else:
            params[name] = sub
    sd = jax_variables_to_state_dict(
        {"params": params,
         "batch_stats": variables_np.get("batch_stats", {})})
    sd.update(fusion)
    return load_strict(EfficientDet(config, device, dtype, param_dtype), sd)


def vgg_from_jax(variables_np, taps=(1, 3, 6, 9),
                 device="cuda") -> VGG16Features:
    """A fresh ``VGG16Features`` to ``max(taps)`` holding the JAX VGG's
    weights (``{"params": {"conv0": ...}}``, as ``torch_vgg16_to_flax``
    gives them)."""
    return load_strict(VGG16Features(taps, device=device),
                       jax_variables_to_state_dict(variables_np))


def adain_decoder_from_jax(variables_np, device="cuda") -> AdaINDecoder:
    """A fresh ``AdaINDecoder`` holding the JAX decoder's weights
    (``{"params": {"dec0": ...}}``)."""
    return load_strict(AdaINDecoder(device=device),
                       jax_variables_to_state_dict(variables_np))


def adain_decoder_to_flax_params(decoder: AdaINDecoder) -> dict:
    """The decoder's weights as the Flax parameter dict of the JAX
    package's decoder npz: ``{"dec0": {"kernel": HWIO, "bias": (O,)},
    ...}``, f32 numpy."""
    return {name: {"kernel": conv.weight.detach().cpu().numpy()
                   .transpose(2, 3, 1, 0).copy(),
                   "bias": conv.bias.detach().cpu().numpy().copy()}
            for name, conv in decoder.named_children()}


def _optax_leaf_state(opt_state, field):
    """The first state in optax's nested tuples that has ``field`` (``mu``
    for Adam's moments, ``trace`` for SGD's momentum; an array's own
    ``trace`` method is no such state)."""
    if hasattr(opt_state, field) and not isinstance(opt_state, np.ndarray):
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
