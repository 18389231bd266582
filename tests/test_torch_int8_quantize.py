"""Calibration and int8 post-training quantization: the port's
``models/quantize.py`` (``calibrate_hrnet``, ``quantize_hrnet``,
``quantize_frcnn_trunk``) and ``models/hrnet.py`` (``quantile_linear``,
``fold_input_normalization``) against ``stlpose_tpu``'s on HRNET_TINY and
FASTER_RCNN_TINY with random weights and BatchNorm statistics.

Both sides quantize the same folded f32 weights (the JAX package's fold,
carried across), so ``kernel_i8`` and ``sw`` are equal exactly. The
calibration statistics come from two f32 programs that sum their
convolutions in other orders (XLA's and PyTorch's CPU backends), and XLA
may contract the quantile's interpolation into an FMA: they, ``sx``, the
unsigned ``bias`` fold, ``zp``, ``qlo`` and ``qhi`` are held within 1e-6
relative (measured: under 3e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu.models.hrnet import fold_batchnorms as jax_fold
from stlpose_tpu.models.hrnet import \
    fold_input_normalization as jax_fold_input
from stlpose_tpu.models.quantize import calibrate_hrnet as jax_calibrate
from stlpose_tpu.models.quantize import quantize_frcnn_trunk as jax_qtrunk
from stlpose_tpu.models.quantize import quantize_hrnet as jax_quantize
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.convert import (jax_variables_to_state_dict,
                                              load_strict)
from stlpose_tpu_torch.models.hrnet import (PoseHighResolutionNet,
                                            fold_input_normalization,
                                            quantile_linear)
from stlpose_tpu_torch.models.quantize import (calibrate_hrnet,
                                               quantize_frcnn_trunk,
                                               quantize_hrnet)
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import jax_hrnet
import tests.torch_threads  # noqa: F401  (caps torch's threads)

REL = 1e-6
STAT_KEYS = ("in_absmax", "in_q999", "in_min")


def flat_stats(tree, prefix=()):
    """The JAX package's nested ``calib_stats`` -> {module name: stats}."""
    out = {}
    for k, v in tree.items():
        if "in_absmax" in v:
            out[".".join(prefix + (k,))] = {
                s: float(np.asarray(v[s]).ravel()[0]) for s in STAT_KEYS}
        else:
            out.update(flat_stats(v, prefix + (k,)))
    return out


def assert_rel(got, ref, rel=REL, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rel * scale, name


@pytest.fixture(scope="module")
def hrnet_calibrated():
    """HRNET_TINY: JAX variables, the JAX fold, a calibration stream of
    two batches, and both packages' statistics on it."""
    _, v = jax_hrnet("tiny", 5)
    folded = jax_fold(v)
    rng = np.random.RandomState(6)
    batches = [rng.randn(2, 256, 192, 3).astype(np.float32) * 1.5
               for _ in range(2)]
    calib = JaxHRNet(config=jax_hrnet_config("tiny"), folded=True,
                     quant="calib")
    ref = flat_stats(jax_calibrate(calib, folded, batches))
    sd = jax_variables_to_state_dict(folded)
    model = load_strict(PoseHighResolutionNet(
        HRNET_TINY, device="cpu", folded=True, quant="calib"), sd)
    got = calibrate_hrnet(model, batches)
    return folded, sd, ref, got


def test_quantile_matches_jnp_quantile():
    """``quantile_linear`` against ``jnp.quantile(.., 0.999)``: sizes where
    the index falls between two values, on one, on ties and at n = 1."""
    rng = np.random.RandomState(0)
    for n in (1, 2, 999, 1000, 1001, 4097, 20000):
        a = np.abs(rng.randn(n)).astype(np.float32)
        if n > 100:
            a[::7] = a[0]
        ref = float(jnp.quantile(jnp.asarray(a), 0.999))
        got = float(quantile_linear(torch.from_numpy(a), 0.999))
        assert abs(got - ref) <= 1e-7 * abs(ref), n


def test_calibration_stats_match_jax(hrnet_calibrated):
    """Every ConvBN of the folded HRNET_TINY (final_layer is none) has its
    three statistics, max/min-reduced over the two batches, within REL of
    the JAX package's; post-ReLU inputs read a minimum of 0."""
    _, _, ref, got = hrnet_calibrated
    assert set(got) == set(ref) and "final_layer" not in got
    assert len(got) == 40                  # every ConvBN of HRNET_TINY
    for name in ref:
        for s in STAT_KEYS:
            assert_rel(got[name][s], ref[name][s], name=f"{name}.{s}")
    assert got["stage2_m0.branch0_block0.cb2"]["in_min"] == 0.0
    assert got["stem1"]["in_min"] < 0.0


@pytest.mark.parametrize("act_scheme,act_clip", [
    ("signed", "absmax"), ("signed", "q999"),
    ("unsigned", "absmax"), ("unsigned", "q999")])
def test_quantize_hrnet_matches_jax(hrnet_calibrated, act_scheme, act_clip):
    """Each scheme and clip basis: from each package's own statistics,
    ``kernel_i8`` and ``sw`` equal, ``sx``, ``bias``, ``zp``, ``qlo``,
    ``qhi`` within REL; ``final_layer`` untouched; unsigned promotes the
    post-ReLU inputs only."""
    folded, sd, ref_stats, got_stats = hrnet_calibrated
    ref_vars = jax_quantize(folded, ref_stats_tree(folded, ref_stats),
                            act_clip=act_clip, act_scheme=act_scheme)
    ref = jax_variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, ref_vars))
    got = quantize_hrnet(sd, got_stats, act_clip=act_clip,
                         act_scheme=act_scheme)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        if k.endswith(("kernel_i8", ".sw")) or k.startswith("final_layer"):
            assert torch.equal(got[k], ref[k]), k
        else:
            assert_rel(got[k].numpy(), ref[k].numpy(), name=k)
    assert torch.equal(got["final_layer.weight"], sd["final_layer.weight"])
    zps = {k: float(v) for k, v in got.items() if k.endswith(".zp")}
    if act_scheme == "signed":
        assert not zps
    else:
        assert zps["stem1.zp"] == 0.0 and \
            zps["stage2_m0.branch0_block0.cb2.zp"] == 128.0


def ref_stats_tree(folded, flat):
    """Flat statistics back into the JAX package's nested tree."""
    tree = {}
    for name, s in flat.items():
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node.update({k: np.float32(v) for k, v in s.items()})
    return tree


def test_quantize_frcnn_trunk_matches_jax():
    """FASTER_RCNN_TINY, one calibration batch, both schemes: the trunk's
    ConvBNs quantized (``kernel_i8`` and ``sw`` equal, the scales and
    biases within REL), ``stem_conv`` folded, FPN, RPN and box head as
    they were, no BatchNorm left."""
    _, dv = jax_detector(3)
    images = np.random.RandomState(7).rand(2, 128, 128, 3).astype(
        np.float32)
    sd = jax_variables_to_state_dict(dv)
    for scheme in ("signed", "unsigned"):
        ref = jax_variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, jax_qtrunk(JAX_TINY, dv, [images],
                                   act_scheme=scheme)))
        got = quantize_frcnn_trunk(FASTER_RCNN_TINY, sd, [images],
                                   act_scheme=scheme)
        assert set(got) == set(ref)
        assert not any(".bn." in k or "stem_bn" in k for k in got)
        for k in ref:
            if k.endswith(("kernel_i8", ".sw")) or not k.startswith(
                    "backbone.layer"):
                if k.startswith("backbone.stem_conv"):
                    np.testing.assert_array_max_ulp(
                        got[k].numpy(), ref[k].numpy(), maxulp=1)
                else:
                    assert torch.equal(got[k], ref[k]), k
            else:
                assert_rel(got[k].numpy(), ref[k].numpy(), name=k)
        n_q = sum(k.endswith("kernel_i8") for k in got)
        assert n_q == 4 * 4                       # 4 blocks x cb1-3, down


def test_fold_input_normalization_matches_jax():
    """The stem's kernel divided by std and the running mean shifted, as
    the JAX package folds them (same f32 numpy operations: equal to 1
    ulp); every other entry passes through."""
    _, v = jax_hrnet("tiny", 8)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    ref = jax_variables_to_state_dict(jax_fold_input(v, mean, std))
    sd = jax_variables_to_state_dict(v)
    got = fold_input_normalization(sd, mean, std)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_max_ulp(got[k].numpy(), ref[k].numpy(),
                                        maxulp=1)
    assert not torch.equal(got["stem1.conv.weight"],
                           sd["stem1.conv.weight"])
