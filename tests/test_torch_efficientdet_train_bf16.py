"""bf16 detector training of the EfficientDet family: the port
(stlpose_tpu_torch/models/efficientdet.py with ``dtype=torch.bfloat16,
param_dtype=torch.float32``, parallel/detector_steps.py,
engines/detector_trainer.py, 02_train_faster_rcnn.py) against the JAX
package's bf16 EfficientDet.loss_fn on EFFICIENTDET_TINY, the same f32
weights (models/convert.py) and batch as
tests/test_torch_efficientdet_train.py. EfficientDet samples nothing and
has no RoIAlign, so the whole loss is held at once.

The bounds and the reference's compilation are those of
tests/test_torch_detector_train_bf16.py: the port's bf16 result no further
from the reference's f32 result than NET_FACTOR (2) times the reference's
own bf16 result, as maxima (and medians) over many values; the reference
compiled with XLA's excess precision off, so that each of its bf16
operations rounds as the source reads; flax's two-pass variance for its
train-mode statistics. Readings on these inputs (port / reference): the
loss terms' largest relative drift 7.2e-4 / 5.8e-4; the gradients' drift of a
tensor's max abs, largest 0.51 / 0.33, median 0.124 / 0.127; the
running statistics' largest 1.2e-3 / 1.4e-3; the noise gradients'
largest 7.1e-4 / 1.2e-2 of the largest gradient.

Gradients that are 0 in exact arithmetic (a bias that a train-mode
BatchNorm follows, the regressor's BatchNorms of levels with no positive
anchor; tests/test_torch_efficientdet_train.py finds them from a float64
reference) are rounding noise in every program: here the tensors whose
f32 reference gradient is at most 1e-4 of the largest. They are left out
of the drift and held as noise: at most NET_FACTOR times the reference's
bf16 noise, each tensor's largest magnitude over the largest gradient.
"""

import importlib

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import efficientdet as jed
from stlpose_tpu_torch.models.convert import (efficientdet_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.parallel.detector_steps import \
    make_detector_train_step
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import checkpoint_path
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.fixtures import make_coco_dataset
from tests.test_torch_detector_train_bf16 import NET_FACTOR, compiled, rel
from tests.test_torch_efficientdet import jax_variables, port_config
from tests.test_torch_efficientdet_train import (EXP, grads_as_port,
                                                 make_batch, torch_batch,
                                                 two_pass_stats)
from tests.test_torch_detector_train import B
import tests.torch_threads  # noqa: F401  (caps torch's threads)

BF16 = torch.bfloat16
TERMS = ("loss_classifier", "loss_box_reg")
NOISE = 1e-4


def reference(dtype, variables, batch):
    """The JAX loss_fn in ``dtype`` on f32 params: value, terms, new
    statistics and gradient."""
    det = jed.EfficientDet(jed.EFFICIENTDET_TINY, dtype=dtype)

    def loss(params, stats, b):
        return det.loss_fn({"params": params, "batch_stats": stats}, b,
                           None)

    fn = jax.value_and_grad(loss, has_aux=True)
    args = (variables["params"], variables["batch_stats"], batch)
    (total, (terms, stats)), grads = compiled(fn, *args)(*args)
    return {"total": np.asarray(total), "terms": jax.device_get(terms),
            "stats": jax.device_get(stats),
            "grads": grads_as_port(jax.device_get(grads))}


@pytest.fixture(scope="module")
def ref():
    """The reference in bf16 and in f32, under the two-pass
    statistics."""
    _, variables = jax_variables(jed.EFFICIENTDET_TINY, 2)
    batch = make_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass_stats)
        out = {"bf16": reference(jnp.bfloat16, variables, batch),
               "f32": reference(jnp.float32, variables, batch)}
    out.update(variables=variables, batch=batch)
    return out


def port_detector(ref, param_dtype=torch.float32):
    return efficientdet_from_jax(ref["variables"],
                                 port_config(jed.EFFICIENTDET_TINY),
                                 device="cpu", dtype=BF16,
                                 param_dtype=param_dtype)


@pytest.fixture(scope="module")
def port_step(ref):
    """The port's bf16 loss_fn and backward."""
    port = port_detector(ref)
    total, terms = port.loss_fn(torch_batch(ref["batch"]))
    total.backward()
    return port, total, terms


def test_loss_terms_are_f32_and_track_jax(ref, port_step):
    """Both terms and their sum f32 in both programs (the f32 targets
    promote the bf16 logits and deltas), finite and positive; the terms'
    largest relative drift from the reference's f32 terms within
    NET_FACTOR of the reference's bf16 terms'."""
    port, total, terms = port_step
    rb, rf = ref["bf16"], ref["f32"]
    assert port.training and set(terms) == set(TERMS)
    assert total.dtype == torch.float32 and rb["total"].dtype == np.float32
    drift = {"port": [], "ref": []}
    for k in TERMS:
        assert terms[k].dtype == torch.float32, k
        assert rb["terms"][k].dtype == jnp.float32, k
        f, got = float(rf["terms"][k]), float(terms[k].detach())
        assert np.isfinite(got) and got > 0, k
        drift["port"].append(abs(got - f) / f)
        drift["ref"].append(abs(float(rb["terms"][k]) - f) / f)
    assert max(drift["port"]) <= NET_FACTOR * max(drift["ref"]), drift


def test_gradients_track_jax(ref, port_step):
    """Every master's gradient f32. Each tensor's drift from the
    reference's f32 gradient (of its max abs): the largest and the median
    within NET_FACTOR of the reference's bf16 gradient's; the tensors
    whose gradient is rounding noise held as noise (module docstring)."""
    port = port_step[0]
    wb, wf = ref["bf16"]["grads"], ref["f32"]["grads"]
    named = dict(port.named_parameters())
    assert set(named) == set(wf) == set(wb)
    top = max(np.abs(w).max() for w in wf.values())
    drift = {"port": [], "ref": []}
    noise = {"port": [], "ref": []}
    for name, p in named.items():
        assert p.dtype == p.grad.dtype == torch.float32, name
        f, b = wf[name], np.asarray(wb[name], np.float32)
        g = p.grad.numpy()
        if np.abs(f).max() <= NOISE * top:
            noise["port"].append(np.abs(g).max() / top)
            noise["ref"].append(np.abs(b).max() / top)
            continue
        drift["port"].append(rel(g, f))
        drift["ref"].append(rel(b, f))
    assert 0 < len(noise["port"]) < len(named) // 4
    for stat in (np.max, np.median):
        assert stat(drift["port"]) <= NET_FACTOR * stat(drift["ref"]), \
            (stat.__name__, stat(drift["port"]), stat(drift["ref"]))
    assert max(noise["port"]) <= NET_FACTOR * max(noise["ref"]), noise


def test_batch_stats_after_one_bf16_step(ref, port_step):
    """The running statistics after the bf16 train-mode forward: f32,
    every one moved, their largest drift from the reference's f32
    statistics (of each tensor's max abs) within NET_FACTOR of the
    reference's bf16 statistics'."""
    got = port_step[0].state_dict()
    wb = jax_variables_to_state_dict({"params": {},
                                      "batch_stats": ref["bf16"]["stats"]})
    wf = jax_variables_to_state_dict({"params": {},
                                      "batch_stats": ref["f32"]["stats"]})
    before = jax_variables_to_state_dict(
        {"params": {}, "batch_stats": ref["variables"]["batch_stats"]})
    drift = {"port": [], "ref": []}
    for k, f in wf.items():
        assert got[k].dtype == wb[k].dtype == torch.float32, k
        assert not torch.equal(got[k], before[k]), k
        drift["port"].append(rel(got[k].numpy(), f.numpy()))
        drift["ref"].append(rel(wb[k].numpy(), f.numpy()))
    assert max(drift["port"]) <= NET_FACTOR * max(drift["ref"]), drift


def test_train_step_keeps_f32_masters_and_moves_them(ref):
    """make_detector_train_step on the bf16 EfficientDet with Adam: a
    finite f32 loss, every master still f32, each one with a gradient
    moved (the regressor's BatchNorms of levels without a positive anchor
    get exactly 0 and stay), Adam's moments f32; a step whose perceptual
    weighting makes the loss infinite leaves every master as it was."""
    port = port_detector(ref)
    perceptual = {**EXP, "training": {**EXP["training"],
                                      "perceptual_loss": True},
                  "dataset": {"dataset_name": "styled_coco"}}
    state = create_train_state(port, perceptual)
    step = make_detector_train_step(perceptual_cfg=perceptual)
    batch = dict(torch_batch(ref["batch"]),
                 perceptual_loss=torch.zeros((B,)))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    m = step(state, batch)
    assert m["loss"].dtype == torch.float32 and float(m["finite"]) == 1.0
    for n, p in port.named_parameters():
        assert p.dtype == torch.float32, n
        assert torch.equal(p, before[n]) == (not bool(p.grad.any())), n
        for v in state.optimizer.state[p].values():
            assert v.dtype == torch.float32, n
    after = {n: p.detach().clone() for n, p in port.named_parameters()}
    m = step(state, dict(batch, perceptual_loss=torch.full((B,),
                                                           float("inf"))))
    assert float(m["finite"]) == 0.0
    for n, p in port.named_parameters():
        assert torch.equal(p, after[n]), n


def test_predict_on_the_masters_equals_the_bf16_serving_detector(ref):
    """Validation's predict on the f32 masters in bf16: the same
    detections, bit for bit, as the bf16 serving EfficientDet (weights
    stored rounded to bf16) from those masters."""
    trained, serving = port_detector(ref), port_detector(ref, None)
    assert serving.classifier.head.pw.weight.dtype == BF16
    images = torch_batch(ref["batch"])["image"]
    got, want = trained.predict(images), serving.predict(images)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_02_trains_efficientdet_in_bf16(tmp_path, monkeypatch):
    """02_train_faster_rcnn.py's main with STLPOSE_DTYPE=bfloat16 and
    STLPOSE_DETECTOR_CONFIG=efficientdet_tiny trains the bf16 EfficientDet
    on f32 masters, writes f32 checkpoints, and 03 evaluates the final one
    in bf16 (12 stats, each -1 or in [0, 1])."""
    data = tmp_path / "data"
    make_coco_dataset(str(data), n_train=4, n_val=2, img_hw=(128, 160))
    monkeypatch.setenv("STLPOSE_DTYPE", "bfloat16")
    monkeypatch.setenv("STLPOSE_DETECTOR_CONFIG", "efficientdet_tiny")
    monkeypatch.setenv("STLPOSE_DETECTOR_PRETRAINED", "")
    exp_path = create_experiment(
        "effdet_bf16", {"batch_size": 2, "num_epochs": 1,
                        "save_frequency": 1, "learning_rate": 1e-3},
        root=str(tmp_path))
    train = importlib.import_module(
        "stlpose_tpu_torch.scripts.02_train_faster_rcnn")
    tr = train.main(["-d", exp_path, "--data_path", str(data), "--device",
                     "cpu"])
    assert type(tr.detector).__name__ == "EfficientDet"
    assert tr.detector.dtype == BF16
    assert {p.dtype for p in tr.detector.parameters()} == {torch.float32}
    blob = torch.load(checkpoint_path(exp_path, "final", detector=True) +
                      ".pt", map_location="cpu", weights_only=True)
    assert {v.dtype for k, v in blob["model_state_dict"].items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
    evaluate = importlib.import_module(
        "stlpose_tpu_torch.scripts.03_evaluate_faster_rcnn")
    stats = evaluate.main(["-d", exp_path, "--checkpoint", "final",
                           "--data_path", str(data), "--device", "cpu"])
    assert len(stats) == 12 and all(s == -1.0 or 0.0 <= s <= 1.0
                                    for s in stats)
