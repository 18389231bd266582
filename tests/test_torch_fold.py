"""BatchNorm folding for the serving flavors: the port's
``models/quantize.py`` against ``stlpose_tpu``'s ``fold_batchnorms`` and
``fold_frcnn_trunk`` on random, non-trivial BatchNorm statistics, and the
folded f32 models against the unfolded ones (HRNET_TINY,
FASTER_RCNN_TINY)."""

import numpy as np
import pytest
import torch

from stlpose_tpu.models.hrnet import fold_batchnorms as jax_fold
from stlpose_tpu.models.quantize import fold_frcnn_trunk as jax_fold_frcnn
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.models.quantize import (apply_trunk_flavor,
                                               fold_batchnorms,
                                               fold_frcnn_trunk)
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import jax_hrnet
import tests.torch_threads  # noqa: F401  (caps torch's threads)


def _assert_within_one_ulp(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_max_ulp(got[k].numpy(), ref[k].numpy(),
                                        maxulp=1)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_fold_batchnorms_matches_jax():
    """HRNet: every ConvBN folded in float64 and rounded once, as the JAX
    package folds it: within 1 f32 ulp, on random scale, shift, mean and
    variance (uniform in [0.5, 1.5] for scale and variance)."""
    _, v = jax_hrnet("tiny", 0)
    sd = jax_variables_to_state_dict(v)
    assert not torch.allclose(sd["stem1.bn.running_var"], torch.ones(16))
    got = fold_batchnorms(sd)
    ref = jax_variables_to_state_dict(jax_fold(v))
    assert "stem1.conv.bias" in got and "stem1.bn.weight" not in got
    _assert_within_one_ulp(got, ref)


def test_fold_frcnn_trunk_matches_jax():
    """The detector: the trunk's ConvBNs and its ``stem_conv``/``stem_bn``
    sibling pair fold; FPN, RPN and box head pass through."""
    _, dv = jax_detector(0)
    sd = jax_variables_to_state_dict(dv)
    got = fold_frcnn_trunk(sd)
    ref = jax_variables_to_state_dict(jax_fold_frcnn(dv))
    assert "backbone.stem_conv.bias" in got
    assert not any("bn" in k for k in got)
    _assert_within_one_ulp(got, ref)
    assert torch.equal(got["fpn.out0.weight"], sd["fpn.out0.weight"])


def test_converters_take_live_or_folded_variables():
    """``hrnet_from_jax(folded=True)`` and ``faster_rcnn_from_jax(
    trunk_quant="folded")`` fold live-BatchNorm variables themselves or
    take variables the JAX package folded (no ``batch_stats``): the same
    weights to 1 ulp either way."""
    _, v = jax_hrnet("tiny", 0)
    a = hrnet_from_jax(v, HRNET_TINY, device="cpu", folded=True)
    b = hrnet_from_jax(jax_fold(v), HRNET_TINY, device="cpu", folded=True)
    _assert_within_one_ulp(a.state_dict(), b.state_dict())
    _, dv = jax_detector(1)
    a = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu",
                             trunk_quant="folded")
    b = faster_rcnn_from_jax(jax_fold_frcnn(dv), FASTER_RCNN_TINY,
                             device="cpu", trunk_quant="folded")
    _assert_within_one_ulp(a.state_dict(), b.state_dict())


def test_folded_f32_models_match_unfolded():
    """f32: the folded HRNet's heatmaps and the folded trunk's FPN maps
    equal the live-BatchNorm models' to 1e-5 of their largest magnitude
    (one rounding of W * f against the BatchNorm's three f32 operations
    after each convolution)."""
    _, v = jax_hrnet("tiny", 2)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 256, 192, 3)
                         .astype(np.float32))
    live = hrnet_from_jax(v, HRNET_TINY, device="cpu")
    folded = hrnet_from_jax(v, HRNET_TINY, device="cpu", folded=True)
    with torch.inference_mode():
        assert _rel(folded(x), live(x)) <= 1e-5
    _, dv = jax_detector(2)
    imgs = torch.from_numpy(np.random.RandomState(4).rand(2, 3, 128, 128)
                            .astype(np.float32))
    live = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu")
    folded = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu",
                                  trunk_quant="folded")
    with torch.inference_mode():
        for a, b in zip(folded.features(imgs), live.features(imgs)):
            assert _rel(a, b) <= 1e-5


def test_model_trained_by_the_port_folds():
    """A model trained by the port (train-mode forwards moved its running
    statistics) folds from its own state dict and loads strictly into the
    folded model; eval heatmaps agree to 1e-5 of their largest magnitude."""
    torch.manual_seed(0)
    model = PoseHighResolutionNet(HRNET_TINY, device="cpu")
    x = torch.randn(2, 256, 192, 3)
    model.train()
    with torch.no_grad():
        for _ in range(2):
            model(x)
    model.eval()
    assert not torch.equal(model.stem1.bn.running_mean, torch.zeros(16))
    folded = PoseHighResolutionNet(HRNET_TINY, device="cpu", folded=True)
    folded.load_state_dict(fold_batchnorms(model.state_dict()))
    with torch.inference_mode():
        assert _rel(folded(x), model(x)) <= 1e-5


def test_trunk_flavors():
    """``apply_trunk_flavor``: "none" leaves the weights as they are,
    "folded" folds the trunk; the int8 PTQ flavors are not ported and say
    where they are queued, in the model's constructor too."""
    _, dv = jax_detector(0)
    sd = jax_variables_to_state_dict(dv)
    assert apply_trunk_flavor(sd, "none") is sd
    assert set(apply_trunk_flavor(sd, "folded")) == set(fold_frcnn_trunk(sd))
    for flavor in ("int8", "int8u"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            apply_trunk_flavor(sd, flavor)
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            FasterRCNN(FASTER_RCNN_TINY, device="cpu", trunk_quant=flavor)
    with pytest.raises(ValueError, match="unknown trunk_quant"):
        apply_trunk_flavor(sd, "fp8")
