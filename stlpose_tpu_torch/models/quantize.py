"""BatchNorm folding for the serving flavors.

Own copy of ``stlpose_tpu/models/hrnet.py::fold_batchnorms`` and of
``stlpose_tpu/models/quantize.py::fold_frcnn_trunk`` /
``apply_trunk_flavor_variables``, on the port's state dicts. At inference
BatchNorm is the per-channel affine ``scale * (conv(x, W) - mu) /
sqrt(var + eps) + bias``; with ``f = scale / sqrt(var + eps)`` it equals
``conv(x, W * f) + (bias - mu * f)``, so each conv/BN pair collapses into
one biased conv (computed in float64, rounded once to f32). Load the
result into a model built with ``folded=True`` (HRNet) or
``trunk_quant="folded"`` (Faster R-CNN). A state dict of a model trained
by the port folds as it is.

The int8 PTQ flavors (``quantize_hrnet``, ``quantize_frcnn_trunk``) are
not ported.
"""

from __future__ import annotations

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
# the eps of every BatchNorm of the port's models (FlaxBatchNorm2d, the
# ResNet stem's stem_bn)
_BN_EPS = 1e-5


def _pairs(state_dict):
    """(conv prefix, bn prefix) of every conv/BN pair: ``X.conv`` with
    ``X.bn`` (a ConvBN) and the ResNet stem's ``stem_conv`` with
    ``stem_bn``."""
    for key in state_dict:
        if key.endswith(".bn.running_var"):
            base = key[:-len(".bn.running_var")]
            yield base + ".conv", base + ".bn"
        elif key.endswith("stem_bn.running_var"):
            base = key[:-len("stem_bn.running_var")]
            yield base + "stem_conv", base + "stem_bn"


def fold_batchnorms(state_dict):
    """Fold every eval-mode BatchNorm into its preceding convolution.

    ``state_dict``: an unfolded model's state dict (running statistics
    included). Returns a new f32 state dict for the folded model: each
    pair's conv gets ``weight * f`` and a bias ``bias - mean * f``, and the
    BatchNorm's entries are gone; every other entry passes through."""
    out = dict(state_dict)
    for conv, bn in list(_pairs(state_dict)):
        W = state_dict[conv + ".weight"].double()
        scale = state_dict[bn + ".weight"].double()
        shift = state_dict[bn + ".bias"].double()
        mu = state_dict[bn + ".running_mean"].double()
        var = state_dict[bn + ".running_var"].double()
        f = scale / torch.sqrt(var + _BN_EPS)
        out[conv + ".weight"] = (W * f[:, None, None, None]).float()
        out[conv + ".bias"] = (shift - mu * f).float()
        for leaf in _BN_LEAVES:
            out.pop(f"{bn}.{leaf}", None)
    return out


def fold_frcnn_trunk(state_dict):
    """Fold the Faster R-CNN ResNet trunk's BatchNorms, the stem pair
    included. Only the trunk carries BatchNorm, so FPN, RPN and box head
    pass through."""
    return fold_batchnorms(state_dict)


def check_trunk_flavor(trunk_quant: str):
    """Raise for a detector trunk flavor the port does not run: the int8
    PTQ flavors of the JAX package are not ported."""
    if trunk_quant in ("int8", "int8u"):
        raise NotImplementedError(
            f"trunk_quant={trunk_quant!r}: the int8 PTQ trunk is not ported "
            "(ROADMAP.md, Queue 1 item 7)")
    if trunk_quant not in ("none", "folded"):
        raise ValueError(f"unknown trunk_quant {trunk_quant!r}")


def apply_trunk_flavor(state_dict, trunk_quant: str):
    """The one entry point for the detector trunk's serving flavors: live
    BatchNorm weights -> weights for ``FasterRCNN(trunk_quant=...)``.
    "none" returns them as they are, "folded" folds the trunk."""
    check_trunk_flavor(trunk_quant)
    return fold_frcnn_trunk(state_dict) if trunk_quant == "folded" \
        else state_dict
