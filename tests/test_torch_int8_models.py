"""The int8 serving models: HRNET_TINY in ``quant="int8"`` / ``"int8u"``
and FASTER_RCNN_TINY with ``trunk_quant="int8"`` / ``"int8u"``, the port
(K6q and K6's plain versions on the CPU) against the JAX package on the
JAX package's own quantized variables (carried across by
``models/convert.py``), and once end to end: the port quantizing from the
same live weights and calibration batch (``quantize_hrnet_from_batches``,
``flavored_state_dict``) against the JAX package doing the same.

Tolerances, measured first. Each int8 layer quantizes the previous
layer's f32 output. Jitted, XLA contracts the epilogue ``acc * (sx * sw)
+ bias`` into one FMA, one ulp off the port's two roundings, and now and
then a value on a rounding boundary then takes the neighbouring code: one
quantization step (1/127 of the layer's absmax) carried through the rest
of the net (jitted, HRNET_TINY's heatmaps read up to 2.2e-2 of their
largest magnitude apart over 3 seeds). So, as in ROADMAP.md Queue 3, the
port is held to the reference run op by op (``jax.disable_jit``), where
every operation rounds once: the heatmaps within 1e-6 of their largest
magnitude (measured 1.5e-7: only ``final_layer``'s f32 convolution sums in
another order), the detector's FPN maps within 2e-6 (measured 6.3e-7).
The detector's ``predict`` is held on the trunk, FPN and RPN head run op
by op and the rest jitted (``jax_predict_exact_trunk``; the whole
``predict`` op by op takes ~30 s to dispatch): valid mask and labels
exact, scores 1e-5, boxes 1e-3 px. End to end the calibration statistics
themselves differ by the two backends' summation order (1e-7 relative),
so codes flip as above: jitted, HRNET_TINY's heatmaps within 5e-2
(measured up to 2.4e-2 over 4 seeds), the detector's FPN maps within
1e-2 (2.8e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu.models.faster_rcnn import FasterRCNNModule
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu.models.hrnet import fold_batchnorms as jax_fold
from stlpose_tpu.models.quantize import calibrate_hrnet as jax_calibrate
from stlpose_tpu.models.quantize import quantize_frcnn_trunk as jax_qtrunk
from stlpose_tpu.models.quantize import quantize_hrnet as jax_quantize
from stlpose_tpu.models.quantize import \
    quantize_hrnet_from_batches as jax_qhrnet
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.kernels import int8_conv as k6
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.quantize import (flavored_state_dict,
                                               quantize_hrnet_from_batches)
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import jax_hrnet
import tests.torch_threads  # noqa: F401  (caps torch's threads)

HM_REL, FPN_REL = 1e-6, 2e-6
E2E_HM_REL, E2E_FPN_REL = 5e-2, 1e-2
QUANTS = {"int8": "signed", "int8u": "unsigned"}


class _ExactTrunk:
    """Stands in for the JAX detector's Flax module: its forward (trunk,
    FPN, RPN head) is given, taken op by op beforehand; every other
    method goes to the module."""

    def __init__(self, module, forward):
        self.module, self.forward = module, forward

    def apply(self, variables, *args, method=None, **kw):
        if method is None:
            return self.forward
        return self.module.apply(variables, *args, method=method, **kw)


# the JAX detector whose predict runs on a given forward: only its box
# head's parameters are read, so both int8 flavors share one compile
_JAX_HEAD = JaxFasterRCNN(JAX_TINY, pallas_roi=False, roi_patch_quant=False,
                           trunk_quant="none")


@jax.jit
def _jax_predict_from_forward(head_params, forward, images):
    module = _JAX_HEAD.module
    _JAX_HEAD.module = _ExactTrunk(module, forward)
    try:
        return _JAX_HEAD.predict({"params": head_params}, images)
    finally:
        _JAX_HEAD.module = module


def jax_predict_exact_trunk(jdet, variables, images):
    """(the FPN maps, ``predict``) of the JAX detector with its forward
    run op by op (so the int8 trunk rounds as the port does) and the rest
    jitted."""
    with jax.disable_jit():
        forward = jdet.module.apply(variables, jnp.asarray(images),
                                    train=False)
    head = {k: v for k, v in variables["params"].items() if k != "backbone"}
    return forward[0], np_tree(_jax_predict_from_forward(
        head, forward, jnp.asarray(images)))


def rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hrnet_case():
    """HRNET_TINY's live JAX variables, its fold, a calibration batch and
    the JAX calibration statistics on it; three test crops."""
    _, v = jax_hrnet("tiny", 11)
    rng = np.random.RandomState(12)
    calib = rng.randn(2, 256, 192, 3).astype(np.float32)
    folded = jax_fold(v)
    stats = jax_calibrate(JaxHRNet(config=jax_hrnet_config("tiny"),
                                   folded=True, quant="calib"),
                          folded, [calib])
    x = rng.randn(3, 256, 192, 3).astype(np.float32)
    return v, folded, stats, calib, x


def jax_heatmaps(quant, qvars, x):
    """The JAX int8 HRNet's heatmaps, run op by op."""
    model = JaxHRNet(config=jax_hrnet_config("tiny"), folded=True,
                     quant=quant)
    with jax.disable_jit():
        return np.asarray(model.apply(qvars, x))


@pytest.mark.parametrize("quant", ["int8", "int8u"])
def test_hrnet_int8_on_jax_variables(hrnet_case, quant):
    """The port's int8 HRNet holding the JAX package's quantized
    variables: heatmaps within HM_REL of the JAX int8 model's run op by
    op, every ConvBN through K6's wrapper once, ``final_layer`` an f32
    conv."""
    _, folded, stats, _, x = hrnet_case
    qvars = np_tree(jax_quantize(folded, stats, act_scheme=QUANTS[quant]))
    ref = jax_heatmaps(quant, qvars, x)
    port = hrnet_from_jax(qvars, HRNET_TINY, device="cpu", folded=True,
                          quant=quant)
    calls = []
    fn = k6.int8_conv
    k6_calls = lambda *a, **kw: calls.append(1) or fn(*a, **kw)  # noqa
    try:
        k6.int8_conv = k6_calls
        with torch.inference_mode():
            got = port(torch.from_numpy(x)).numpy()
    finally:
        k6.int8_conv = fn
    assert len(calls) == 40
    assert port.final_layer.weight.dtype == torch.float32
    assert got.shape == ref.shape == (3, 64, 48, 17)
    assert rel(got, ref) <= HM_REL


def test_hrnet_quantize_from_batches_end_to_end(hrnet_case):
    """``quantize_hrnet_from_batches`` ("int8"; the detector's end-to-end
    test below takes "int8u") from the live weights and the calibration
    batch, both packages: the same int8 weights, and heatmaps within
    E2E_HM_REL of each other (jitted; in the JAX package's order: fold,
    calibrate, quantize)."""
    quant = "int8"
    v, _, _, calib, x = hrnet_case
    qvars, model = jax_qhrnet("tiny", v, [calib],
                              act_scheme=QUANTS[quant])
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x))(qvars, x))
    qsd, port = quantize_hrnet_from_batches(
        "tiny", jax_variables_to_state_dict(v), [calib], device="cpu",
        act_scheme=QUANTS[quant])
    assert port.quant == quant
    ref_sd = jax_variables_to_state_dict(np_tree(qvars))
    n_i8 = [k for k in ref_sd if k.endswith("kernel_i8")]
    assert len(n_i8) == 40
    same = np.mean([torch.equal(qsd[k], ref_sd[k]) for k in n_i8])
    assert same >= 0.95          # the two folds differ by an ulp at most
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert rel(got, ref) <= E2E_HM_REL


@pytest.fixture(scope="module")
def detector_case():
    """FASTER_RCNN_TINY's live JAX variables, a calibration batch, two
    test images."""
    _, dv = jax_detector(13)
    rng = np.random.RandomState(14)
    calib = rng.rand(2, 128, 128, 3).astype(np.float32)
    images = rng.rand(2, 128, 128, 3).astype(np.float32)
    return dv, calib, images


@pytest.mark.parametrize("quant", ["int8", "int8u"])
def test_detector_int8_trunk_on_jax_variables(detector_case, quant):
    """The port's FasterRCNN(trunk_quant=...) holding the JAX package's
    ``quantize_frcnn_trunk`` variables against the JAX int8 detector run
    op by op: FPN maps within FPN_REL; ``predict`` (on the exact trunk)
    valid mask and labels exact, scores 1e-5, boxes 1e-3 px."""
    dv, calib, images = detector_case
    qv = np_tree(jax_qtrunk(JAX_TINY, dv, [calib],
                            act_scheme=QUANTS[quant]))
    jdet = JaxFasterRCNN(JAX_TINY, pallas_roi=False, trunk_quant=quant)
    ref_f, ref = jax_predict_exact_trunk(jdet, qv, images)
    port = faster_rcnn_from_jax(qv, FASTER_RCNN_TINY, device="cpu",
                                trunk_quant=quant)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        got_f = port.features(x)
    for a, b in zip(got_f, ref_f):
        assert rel(a.permute(0, 2, 3, 1).numpy(), np.asarray(b)) <= FPN_REL
    got = port.predict(torch.from_numpy(images))
    assert ref["valid"].any()
    for k in ("valid", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"],
                               atol=1e-3, rtol=0)


def test_detector_int8_trunk_end_to_end(detector_case):
    """``flavored_state_dict`` from live weights and one calibration batch
    in both packages ("int8u" through the JAX package's
    ``apply_trunk_flavor_variables``): FPN maps within E2E_FPN_REL
    (jitted); without
    calibration images both refuse the int8 flavors."""
    from stlpose_tpu.models.quantize import apply_trunk_flavor_variables
    dv, calib, images = detector_case
    qv = np_tree(apply_trunk_flavor_variables(JAX_TINY, dv, "int8u",
                                              calib_batches=[calib]))
    jdet = JaxFasterRCNN(JAX_TINY, pallas_roi=False, trunk_quant="int8u")
    ref_f = jax.jit(lambda v, x: jdet.module.apply(
        v, x, train=False, method=FasterRCNNModule.features))(qv, images)
    sd = jax_variables_to_state_dict(dv)
    port = FasterRCNN(FASTER_RCNN_TINY, device="cpu", trunk_quant="int8u")
    port.load_state_dict(flavored_state_dict(
        sd, "int8u", config=FASTER_RCNN_TINY, calib_batches=[calib]))
    with torch.inference_mode():
        got_f = port.features(torch.from_numpy(images).permute(0, 3, 1, 2))
    for a, b in zip(got_f, ref_f):
        assert rel(a.permute(0, 2, 3, 1).numpy(),
                   np.asarray(b)) <= E2E_FPN_REL
    for q in ("int8", "int8u"):
        with pytest.raises(ValueError, match="requires calibration"):
            apply_trunk_flavor_variables(JAX_TINY, dv, q)
        with pytest.raises(ValueError, match="requires calibration"):
            flavored_state_dict(sd, q, config=FASTER_RCNN_TINY)
