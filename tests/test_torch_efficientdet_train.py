"""EfficientDet training and weights: the port's ``EfficientDet.loss_fn``
(stlpose_tpu_torch/models/efficientdet.py), its train step
(parallel/detector_steps.py), its zylo117 converter
(models/convert_detector.py::torch_efficientdet_to_port) and the
EfficientDet names of engines/detector_trainer.py::build_detector against
the JAX package's, on the same numpy weights and batch.

The reference's train-mode BatchNorm statistics are taken with flax's
two-pass variance, as in tests/test_torch_detector_train.py (its one-pass
E[x^2] - E[x]^2 moves the reference's own train-mode features by ~1e-4
relative). The gradients of both float32 programs are held against the
reference's gradient in float64: the JAX detector built with float64
convolutions under ``jax.enable_x64``, its BatchNorms (float32 in the
model) patched to compute and return float64. The patches are undone when
the module's reference computations end.
"""

import dataclasses
import functools

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.engines import detector_trainer as jax_detector_trainer
from stlpose_tpu.models import efficientdet as jed
from stlpose_tpu.models.convert_detector import torch_efficientdet_to_flax
from stlpose_tpu_torch.engines.detector_trainer import (
    build_detector, load_detector_pretrained)
from stlpose_tpu_torch.models.convert import (efficientdet_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.models.convert_detector import \
    torch_efficientdet_to_port
from stlpose_tpu_torch.models.efficientdet import EfficientDet
from stlpose_tpu_torch.parallel.detector_steps import \
    make_detector_train_step
from stlpose_tpu_torch.train.state import create_train_state
from tests.test_efficientdet_convert import TINY2, _flax_to_torch_names
from tests.test_torch_efficientdet import jax_variables, port_config
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B, K, S = 2, 3, 128
T = torch.from_numpy
EXP = {"training": {"learning_rate": 1e-3, "optimizer": "adam"},
       "dataset": {"dataset_name": "coco"}}


def two_pass_stats(*args, **kw):
    kw["use_fast_variance"] = False
    return TWO_PASS_ORIG(*args, **kw)


def two_pass_stats_f64(x, axes, dtype=None, **kw):
    return two_pass_stats(x, axes, jnp.float64, **kw)


def normalize_f64(mdl, x, mean, var, reduction_axes, feature_axes, dtype,
                  *args):
    return NORMALIZE_ORIG(mdl, x, mean, var, reduction_axes, feature_axes,
                          jnp.float64, *args)


TWO_PASS_ORIG = flax_norm._compute_stats
NORMALIZE_ORIG = flax_norm._normalize


def make_batch(seed=1):
    """Image 0 with three person boxes (K = 3 slots), image 1 with none:
    every anchor of image 1 matches a padding box (label -1, a zero
    one-hot row) and its box loss divides by max(0, 1)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, K, 4), np.float32)
    for k in range(K):
        xy = rng.uniform(0, 70, 2)
        wh = rng.uniform(28, 56, 2)
        boxes[0, k] = [xy[0], xy[1], xy[0] + wh[0], xy[1] + wh[1]]
    mask = np.zeros((B, K), np.float32)
    mask[0] = 1.0
    return {"image": rng.rand(B, S, S, 3).astype(np.float32),
            "boxes": boxes, "labels": mask.astype(np.int32),
            "box_mask": mask}


@pytest.fixture(scope="module")
def ref():
    """loss_fn's value, gradient and updated statistics on the JAX tiny
    detector, under the two-pass statistics."""
    det, variables = jax_variables(jed.EFFICIENTDET_TINY, 2)
    batch = make_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass_stats)

        def loss(params, stats, b):
            return det.loss_fn({"params": params, "batch_stats": stats}, b,
                               None)

        (total, (terms, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"],
                                 variables["batch_stats"], batch)
    return {"variables": variables, "batch": batch, "total": float(total),
            "terms": {k: float(v) for k, v in terms.items()},
            "stats": jax.device_get(stats), "grads": jax.device_get(grads),
            "grads_f64": reference_gradients_f64(variables, batch)}


def reference_gradients_f64(variables, batch):
    """The JAX loss_fn's gradient with every operation in float64."""
    det = jed.EfficientDet(jed.EFFICIENTDET_TINY, dtype=jnp.float64)
    to64 = functools.partial(jax.tree_util.tree_map,
                             lambda a: np.asarray(a, np.float64))
    batch = {k: to64(v) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass_stats_f64)
        mp.setattr(flax_norm, "_normalize", normalize_f64)

        def loss(params, stats, b):
            return det.loss_fn({"params": params, "batch_stats": stats}, b,
                               None)[0]

        grads = jax.jit(jax.grad(loss))(to64(variables["params"]),
                                        to64(variables["batch_stats"]),
                                        batch)
        grads = jax.device_get(grads)
    assert all(g.dtype == np.float64
               for g in jax.tree_util.tree_leaves(grads))
    return grads


def port_detector(ref):
    return efficientdet_from_jax(ref["variables"],
                                 port_config(jed.EFFICIENTDET_TINY),
                                 device="cpu")


def torch_batch(batch):
    return {k: T(v) for k, v in batch.items()}


def grads_as_port(grads):
    """The JAX gradient tree in the port's names (fusion weights
    included)."""
    flat, fusion = {}, {}
    for name, sub in grads.items():
        if name.startswith("bifpn_"):
            fusion.update({f"{name}.{k}": np.asarray(v)
                           for k, v in sub.items() if k.startswith("w_")})
            sub = {k: v for k, v in sub.items() if not k.startswith("w_")}
        flat[name] = sub
    out = {k: v.numpy() for k, v in
           jax_variables_to_state_dict({"params": flat}).items()}
    out.update(fusion)
    return out


def port_gradients_f64(ref):
    """loss_fn's gradient from the port in float64."""
    port = port_detector(ref).double()
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in torch_batch(ref["batch"]).items()}
    port.loss_fn(batch)[0].backward()
    return {n: p.grad.numpy() for n, p in port.named_parameters()}


def test_loss_fn_terms_and_gradients_match_jax(ref):
    """Focal and smooth-L1 terms within 1e-5 relative (one image with no
    boxes). Every parameter's gradient, from the port and from the
    reference in float32, within 1e-4 of its max abs of the reference's
    float64 gradient (the widest readings: the P7 fusion weights, whose
    gradient sums terms that cancel, 3.6e-5 for the port and 6.2e-5 for
    the reference). The port's own float64 gradient within 1e-6 of it
    (5.8e-8 read), which shows that the float64 reference really runs in
    float64. A gradient that is 0 in exact arithmetic (a bias followed
    through linear maps by a train-mode BatchNorm, which removes any
    shift; the regressor's BatchNorms of levels with no positive anchor)
    is rounding noise in both float32 programs: within 1e-4 of the
    largest gradient on both sides (3.8e-7 read)."""
    port = port_detector(ref)
    total, terms = port.loss_fn(torch_batch(ref["batch"]))
    assert port.training and set(terms) == set(ref["terms"])
    total.backward()
    for k, v in ref["terms"].items():
        assert v > 0, k
        np.testing.assert_allclose(float(terms[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), ref["total"],
                               rtol=1e-5)
    want = grads_as_port(ref["grads"])
    exact = grads_as_port(ref["grads_f64"])
    port64 = port_gradients_f64(ref)
    named = dict(port.named_parameters())
    assert set(named) == set(want) == set(exact) == set(port64)
    top = max(np.abs(w).max() for w in exact.values())
    zero = {n for n, w in exact.items() if np.abs(w).max() <= 1e-9 * top}
    assert 0 < len(zero) < len(named) // 4, sorted(zero)
    for name, p in named.items():
        w, g, e = want[name], p.grad.numpy(), exact[name]
        if name in zero:
            assert max(np.abs(w).max(), np.abs(g).max()) <= 1e-4 * top, name
            continue
        scale = np.abs(e).max()
        np.testing.assert_allclose(port64[name], e, rtol=0,
                                   atol=1e-6 * scale, err_msg=name)
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(w, e, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_batch_stats_after_one_step_match_jax(ref):
    """Every running statistic after one train-mode forward within 1e-6
    (flax's momentum 0.99 and biased variance)."""
    port = port_detector(ref)
    with torch.no_grad():
        port.loss_fn(torch_batch(ref["batch"]))
    got = port.state_dict()
    want = jax_variables_to_state_dict({"params": {},
                                        "batch_stats": ref["stats"]})
    assert len(want) == 2 * sum(1 for k in got if k.endswith("running_var"))
    before = jax_variables_to_state_dict(
        {"params": {}, "batch_stats": ref["variables"]["batch_stats"]})
    for k, w in want.items():
        assert not torch.equal(w, before[k]), k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_train_step_and_predict_after_it(ref):
    """make_detector_train_step takes EfficientDet: the loss before the
    update equals loss_fn's, the two terms are reported, every parameter
    with a gradient moves (the regressor's BatchNorms of levels without a
    positive anchor get exactly 0 and stay); predict after it runs
    eval-mode BatchNorm (the same as a fresh detector holding the updated
    weights)."""
    port = port_detector(ref)
    state = create_train_state(port, EXP)
    step = make_detector_train_step()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    metrics = step(state, torch_batch(ref["batch"]))
    assert set(metrics) == {"loss", "finite", "loss_classifier",
                            "loss_box_reg"}
    assert float(metrics["finite"]) == 1.0
    np.testing.assert_allclose(float(metrics["loss"]), ref["total"],
                               rtol=1e-5)
    for k, p in port.named_parameters():
        assert torch.equal(p.detach(), before[k]) == \
            (not bool(p.grad.any())), k
    x = T(ref["batch"]["image"])
    got = port.predict(x)
    assert not port.training
    fresh = port_detector(ref)
    fresh.load_state_dict(port.state_dict())
    want = fresh.predict(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _checkpoint(cfg, seed):
    """(JAX variables, synthetic zylo117 state dict) of ``cfg``."""
    _, variables = jax_variables(cfg, seed)
    return variables, _flax_to_torch_names(variables)


@pytest.mark.parametrize("case", ["same_classes", "person_of_90",
                                  "classes_5_6_of_90", "header_dropped"])
def test_zylo117_converter_matches_jax(case):
    """torch_efficientdet_to_port against torch_efficientdet_to_flax on
    the synthetic zylo117 dict of tests/test_efficientdet_convert.py
    (TINY2: two BiFPN cells), with the official checkpoints' 90-class
    header sliced to one class, to two consecutive classes, or dropped;
    every tensor equal, bit for bit, to the Flax tree's carried across."""
    cfg = TINY2 if case != "classes_5_6_of_90" else \
        dataclasses.replace(TINY2, num_classes=2)
    variables, state = _checkpoint(cfg, 4)
    state["backbone_net.model._bn0.num_batches_tracked"] = np.asarray(0)
    kw = {"num_classes": cfg.num_classes}
    if case != "same_classes":
        n_anchors, start = 9, {"classes_5_6_of_90": 5}.get(case, 0)
        w = state["classifier.header.pointwise_conv.conv.weight"]
        b = state["classifier.header.pointwise_conv.conv.bias"]
        rng = np.random.RandomState(5)
        w90 = rng.randn(n_anchors * 90, *w.shape[1:]).astype(np.float32)
        b90 = rng.randn(n_anchors * 90).astype(np.float32)
        for a in range(n_anchors):
            for c in range(cfg.num_classes):
                w90[a * 90 + start + c] = w[a * cfg.num_classes + c]
                b90[a * 90 + start + c] = b[a * cfg.num_classes + c]
        state["classifier.header.pointwise_conv.conv.weight"] = w90
        state["classifier.header.pointwise_conv.conv.bias"] = b90
        kw["person_class"] = None if case == "header_dropped" else start
    got = torch_efficientdet_to_port(state, **kw)
    flax = torch_efficientdet_to_flax(state, **kw)
    if case == "header_dropped":
        assert "head" not in flax["params"]["classifier"]
        assert not any(k.startswith("classifier.head.") for k in got)
        # the rest carried across: put the model's own header back
        flax["params"]["classifier"]["head"] = \
            variables["params"]["classifier"]["head"]
    want = efficientdet_from_jax(flax, port_config(cfg),
                                 device="cpu").state_dict()
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    if case == "header_dropped":
        want = {k: v for k, v in want.items()
                if not k.startswith("classifier.head.")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    if case == "classes_5_6_of_90":
        with pytest.raises(ValueError, match="cannot slice"):
            torch_efficientdet_to_port(state, num_classes=2,
                                       person_class=89)


def test_pretrained_pth_loads_into_efficientdet(tmp_path):
    """load_detector_pretrained's EfficientDet branch: a torch.save'd
    zylo117 .pth (a DataParallel ``module.`` prefix, a 90-class header)
    loads into the port's detector, equal to the weights carried across
    from the JAX tree; a key the layout does not know raises."""
    variables, state = _checkpoint(TINY2, 6)
    w = state["classifier.header.pointwise_conv.conv.weight"]
    b = state["classifier.header.pointwise_conv.conv.bias"]
    w90 = np.zeros((9 * 90, *w.shape[1:]), np.float32)
    b90 = np.zeros((9 * 90,), np.float32)
    w90[::90], b90[::90] = w, b
    state["classifier.header.pointwise_conv.conv.weight"] = w90
    state["classifier.header.pointwise_conv.conv.bias"] = b90
    path = tmp_path / "efficientdet-tiny2.pth"
    torch.save({"module." + k: T(np.ascontiguousarray(v))
                for k, v in state.items()}, str(path))
    port = EfficientDet(port_config(TINY2), device="cpu")
    sd = load_detector_pretrained(port, str(path))
    want = efficientdet_from_jax(variables, port_config(TINY2),
                                 device="cpu").state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert set(sd) == {k for k in want if
                       not k.endswith("num_batches_tracked")}
    state["bifpn.0.p9_w3"] = np.ones(2, np.float32)
    with pytest.raises(KeyError, match="Unrecognized EfficientDet"):
        torch_efficientdet_to_port(state)


@pytest.mark.parametrize("name, det_type", [
    ("efficientdet", ""), ("efficientdet", "d3"), ("efficientdet_d0", ""),
    ("efficientdet_tiny", "")])
def test_build_detector_builds_efficientdet(name, det_type):
    """The EfficientDet names build an EfficientDet with the reference's
    config (D0, D3 through ``detector_type``, D0, tiny), every field
    equal."""
    exp = {"model": {"detector_name": name, "detector_type": det_type}}
    ref = jax_detector_trainer.build_detector(exp)[1]
    det, cfg = build_detector(exp, device="cpu")
    assert isinstance(det, EfficientDet) and det.config is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.image_size == (128 if name == "efficientdet_tiny" else
                              896 if det_type == "d3" else 512)
