"""BatchNorm folding and int8 post-training quantization (PTQ) for the
serving flavors.

Own copy of ``stlpose_tpu/models/hrnet.py::fold_batchnorms`` and of
``stlpose_tpu/models/quantize.py`` (``calibrate_hrnet``,
``quantize_hrnet``, ``fold_frcnn_trunk``, ``quantize_frcnn_trunk``,
``apply_trunk_flavor_variables``, ``quantize_hrnet_from_batches``), on
the port's state dicts.

Folding: at inference BatchNorm is the per-channel affine ``scale *
(conv(x, W) - mu) / sqrt(var + eps) + bias``; with ``f = scale /
sqrt(var + eps)`` it equals ``conv(x, W * f) + (bias - mu * f)``, so each
conv/BN pair collapses into one biased conv (computed in float64, rounded
once to f32). Load the result into a model built with ``folded=True``
(HRNet) or ``trunk_quant="folded"`` (Faster R-CNN). A state dict of a
model trained by the port folds as it is.

PTQ, w8a8: the folded graph runs in ``quant="calib"`` over calibration
batches and records each ConvBN input's absmax, 0.999 quantile of |x| and
minimum (``calibrate_hrnet``). ``quantize_hrnet`` then quantizes the
weights once on the host, per output channel (``sw = max|W| / 127``,
``rint``, half to even), and takes a per-tensor activation scale from the
calibration: "signed" (``quant="int8"``) ``sx = basis / 127``; "unsigned"
(``quant="int8u"``) gives a post-ReLU input (calibrated minimum >= 0) a
zero point of 128 and ``sx = basis / 255``, its ``zp * sum(w8)`` term
folded into the bias. The int8 weights are re-laid once, here, into the
layout kernel K6 reads (``kernels/int8_conv.py::relayout_kernel_i8``).
HRNet's ``final_layer`` and the ResNet's ``stem_conv`` stay float convs.
"""

from __future__ import annotations

import numpy as np
import torch

from stlpose_tpu_torch.kernels.int8_conv import relayout_kernel_i8
from stlpose_tpu_torch.models.hrnet import ConvBN, compute_in, create_hrnet

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
# the eps of every BatchNorm of the port's models (FlaxBatchNorm2d, the
# ResNet stem's stem_bn)
_BN_EPS = 1e-5
TRUNK_FLAVORS = ("none", "folded", "int8", "int8u")
# act_scheme -> the ConvBN quant mode it serves
ACT_SCHEMES = {"signed": "int8", "unsigned": "int8u"}


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


@torch.inference_mode()
def calibrate_hrnet(model_calib, batches):
    """Run a folded model whose ConvBNs are in ``quant="calib"`` over
    ``batches`` and return each ConvBN's statistics, max-reduced (the
    minimum min-reduced) over the batches: {module name: {"in_absmax",
    "in_q999", "in_min"} as floats}.

    ``model_calib``: e.g. ``create_hrnet(..., folded=True,
    quant="calib")`` (batches (N, H, W, 3), normalized as serving will
    normalize them) or a ``ResNet(folded=True, quant="calib")`` trunk
    (batches (N, 3, S, S)), in the serving dtype. Batches are moved to the
    model's device as f32."""
    convs = [(name, m) for name, m in model_calib.named_modules()
             if isinstance(m, ConvBN) and m.quant == "calib"]
    if not convs:
        raise ValueError("calibrate_hrnet: the model has no ConvBN in "
                         "quant='calib'")
    dev = next(model_calib.parameters()).device
    for _, m in convs:
        m.calib_stats = None
    seen = 0
    for x in batches:
        model_calib(torch.as_tensor(x, dtype=torch.float32, device=dev))
        seen += 1
    if not seen:
        raise ValueError("calibration stream was empty")
    stats = {name: {k: float(v) for k, v in m.calib_stats.items()}
             for name, m in convs}
    for _, m in convs:
        m.calib_stats = None
    return stats


def quantize_hrnet(folded_state_dict, calib_stats, min_scale: float = 1e-8,
                   act_clip: str = "absmax", act_scheme: str = "signed"):
    """Folded f32 state dict + ``calibrate_hrnet`` statistics -> the state
    dict of the int8 model (``quant`` = ``ACT_SCHEMES[act_scheme]``).

    Every ConvBN with statistics (``X.conv.weight`` / ``X.conv.bias``) is
    rewritten to ``X.kernel_i8`` (int8, K6's layout), ``X.sw``, ``X.sx``,
    ``X.bias`` and, unsigned, ``X.zp``, ``X.qlo``, ``X.qhi``; every other
    entry (HRNet's ``final_layer``, the ResNet's ``stem_conv``) passes
    through. ``act_clip`` picks the activation-scale basis: "absmax"
    (never clips) or "q999" (the calibrated 0.999 quantile of |x|). The
    arithmetic is the JAX package's, in numpy: ``sw`` and the codes in
    float64, the unsigned bias fold ``bias + f32(zp * sx) * f32(sum w8) *
    f32(sw)`` in f32, in that order."""
    key = {"q999": "in_q999", "absmax": "in_absmax"}[act_clip]
    if act_scheme not in ACT_SCHEMES:
        raise ValueError(f"unknown act_scheme {act_scheme!r}")
    out = dict(folded_state_dict)
    for name, s in calib_stats.items():
        wkey, bkey = f"{name}.conv.weight", f"{name}.conv.bias"
        if wkey not in out or bkey not in out:
            continue
        W = out.pop(wkey).detach().cpu().double().numpy()   # (O, I, kh, kw)
        bias = out.pop(bkey).detach().cpu().float().numpy()
        sw = np.maximum(np.abs(W).max(axis=(1, 2, 3)) / 127.0, min_scale)
        w8 = np.clip(np.rint(W / sw[:, None, None, None]), -127,
                     127).astype(np.int8)
        basis = float(np.float32(s.get(key, s["in_absmax"])))
        xmin = float(np.float32(s["in_min"])) if "in_min" in s else -np.inf
        q = {"kernel_i8": relayout_kernel_i8(torch.from_numpy(w8)),
             "sw": sw.astype(np.float32)}
        if act_scheme == "signed":
            q["sx"] = np.float32(max(basis / 127.0, min_scale))
            q["bias"] = bias
        else:
            if xmin >= -1e-6:
                # post-ReLU input: shifted-unsigned (zp 128, [0, 255]); the
                # conv pads with -zp, which subtracts zp * sum(w8) from
                # every output: folded back into the bias here
                zp, qlo, qhi = 128.0, 0.0, 255.0
                sx = max(basis / 255.0, min_scale)
            else:
                zp, qlo, qhi = 0.0, -127.0, 127.0
                sx = max(basis / 127.0, min_scale)
            bias = (bias + np.float32(zp * sx)
                    * w8.sum(axis=(1, 2, 3)).astype(np.float32)
                    * sw.astype(np.float32))
            q.update(sx=np.float32(sx), zp=np.float32(zp),
                     qlo=np.float32(qlo), qhi=np.float32(qhi),
                     bias=bias.astype(np.float32))
        for leaf, v in q.items():
            out[f"{name}.{leaf}"] = torch.as_tensor(v)
    return out


def quantize_frcnn_trunk(config, state_dict, batches, dtype=torch.float32,
                         act_scheme: str = "signed"):
    """Fold, calibrate and int8-quantize the detector's ResNet trunk.

    ``state_dict``: a live-BatchNorm ``FasterRCNN`` state dict (the
    checkpoints' form); ``batches``: image batches (N, S, S, 3), 0-1
    floats as ``FasterRCNN.predict`` sees them, over which the folded
    trunk is calibrated in ``dtype`` (the serving dtype) on the state
    dict's device. ``stem_conv``, FPN, RPN and box head
    stay as folded. Returns the state dict of
    ``FasterRCNN(trunk_quant=ACT_SCHEMES[act_scheme])``."""
    from stlpose_tpu_torch.models.convert import load_strict
    from stlpose_tpu_torch.models.resnet import ResNet

    folded = fold_frcnn_trunk(state_dict)
    pre = "backbone."
    bb = {k[len(pre):]: v for k, v in folded.items() if k.startswith(pre)}
    device = next(iter(bb.values())).device
    calib = ResNet(config.stage_sizes, config.width, folded=True,
                   quant="calib")
    load_strict(compute_in(calib.to(device), dtype).eval(), bb)
    stats = calibrate_hrnet(
        calib, (torch.as_tensor(b, dtype=torch.float32, device=device)
                .permute(0, 3, 1, 2).contiguous() for b in batches))
    qbb = quantize_hrnet(bb, stats, act_scheme=act_scheme)
    out = {k: v for k, v in folded.items() if not k.startswith(pre)}
    out.update({pre + k: v for k, v in qbb.items()})
    return out


def check_trunk_flavor(trunk_quant: str):
    """Raise for a detector trunk flavor that does not exist."""
    if trunk_quant not in TRUNK_FLAVORS:
        raise ValueError(f"unknown trunk_quant {trunk_quant!r}")


def flavored_state_dict(state_dict, trunk_quant: str, config=None,
                        calib_batches=None, dtype=torch.float32):
    """The one entry point for the detector trunk's serving flavors: live
    BatchNorm weights -> weights for ``FasterRCNN(trunk_quant=...)``.
    "none" returns them as they are, "folded" folds the trunk, "int8" /
    "int8u" fold and quantize it (``quantize_frcnn_trunk`` with the act
    scheme "signed" / "unsigned"), calibrating on ``calib_batches`` (image
    batches in the predict convention, required) with the trunk in
    ``dtype``, the serving dtype, on the state dict's device; ``config``
    is the detector's ``FasterRCNNConfig``."""
    check_trunk_flavor(trunk_quant)
    if trunk_quant == "none":
        return state_dict
    if trunk_quant == "folded":
        return fold_frcnn_trunk(state_dict)
    if not calib_batches:
        raise ValueError(f"trunk_quant={trunk_quant!r} requires calibration "
                         f"images (calib_batches)")
    if config is None:
        raise ValueError(f"trunk_quant={trunk_quant!r} needs the detector's "
                         "config (the trunk geometry)")
    return quantize_frcnn_trunk(
        config, state_dict, calib_batches, dtype=dtype,
        act_scheme="signed" if trunk_quant == "int8" else "unsigned")


def quantize_hrnet_from_batches(config_name, state_dict, batches,
                                device="cuda", dtype=torch.float32,
                                act_scheme: str = "signed"):
    """One shot: fold -> calibrate -> quantize an unfolded HRNet state dict
    on ``batches`` (normalized inputs (N, H, W, 3)). Returns (the int8
    state dict, the int8 model holding it) in ``dtype`` on ``device``."""
    from stlpose_tpu_torch.models.convert import load_strict

    folded = fold_batchnorms(state_dict)
    calib = create_hrnet(config_name, device, dtype, folded=True,
                         quant="calib")
    load_strict(calib, folded)
    stats = calibrate_hrnet(calib, batches)
    qsd = quantize_hrnet(folded, stats, act_scheme=act_scheme)
    model = create_hrnet(config_name, device, dtype, folded=True,
                         quant=ACT_SCHEMES[act_scheme])
    return qsd, load_strict(model, qsd)
