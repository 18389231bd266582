"""One pose train step of the port (stlpose_tpu_torch/parallel/steps.py)
against stlpose_tpu's ``make_train_step`` on a 1-device CPU mesh, on the
same HRNET_TINY weights and batch (B = 4), plus a second step continued
from the JAX state through ``train_state_from_jax``; the optimizers given
the same gradients; the eval step, metric accumulator, schedulers and
perceptual-loss weighting.

Tolerances are relative to each tensor's largest magnitude: f32
convolutions are summed in another order by XLA's and PyTorch's CPU
backends (forward 1e-5, gradients 1e-4), and BatchNorm's batch variance
is E[x^2] - E[x]^2 in flax and a two-pass sum in PyTorch. The weights
(seed 5) and batches (seeds 1 and 3) are ones where no ReLU input lies
within that rounding of zero: where one does, its gradient flips between
the two backends, and the flip moves the stem's gradients by up to a few
percent (batch seeds 2 and 7 show it)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stlpose_tpu.ops.heatmap import generate_targets as jax_targets
from stlpose_tpu.parallel.mesh import get_mesh
from stlpose_tpu.parallel.steps import MetricAccumulator as JaxAccumulator
from stlpose_tpu.parallel.steps import make_eval_step as jax_eval_step
from stlpose_tpu.parallel.steps import make_train_step as jax_train_step
from stlpose_tpu.train import loss as jax_loss
from stlpose_tpu.train import optim as jax_optim
from stlpose_tpu.train.state import create_train_state as jax_create_state
from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.models.convert import (hrnet_from_jax,
                                              jax_variables_to_state_dict,
                                              train_state_from_jax)
from stlpose_tpu_torch.parallel.steps import (MetricAccumulator,
                                              make_eval_step,
                                              make_train_step)
from stlpose_tpu_torch.train import loss as port_loss
from stlpose_tpu_torch.train import optim as port_optim
from stlpose_tpu_torch.train.state import create_train_state
from tests.test_torch_hrnet import jax_hrnet

B = 4


def _exp(optimizer="adam", **training):
    t = {"learning_rate": 1e-3, "optimizer": optimizer, "momentum": 0.9,
         "nesterov": False, "learning_rate_factor": 0.5, "patience": 2,
         "perceptual_loss": True}
    t.update(training)
    return {"training": t,
            "dataset": {"dataset_name": "styled_coco", "alpha": "0.5",
                        "styles": "all"}}


def _batch(seed):
    """Image, Gaussian targets of random crop-space joints (some off the
    crop, some invisible) and per-sample perceptual losses, as numpy."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(-20, 210, (B, 17, 2)).astype(np.float32)
    joints[..., 1] *= 256 / 192
    vis = (rng.rand(B, 17) > 0.2).astype(np.float32)
    target, weight = jax_targets(jnp.asarray(joints), jnp.asarray(vis))
    return {"image": rng.randn(B, 256, 192, 3).astype(np.float32),
            "target": np.asarray(target), "target_weight": np.asarray(weight),
            "perceptual_loss": rng.uniform(0, 2, B).astype(np.float32)}


def _to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() /
                 max(np.abs(np.asarray(ref)).max(), 1e-30))


def _capture_grads(tx):
    """``tx`` that also keeps the step's gradients in its state, so the
    JAX step's own gradients can be read."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                        params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps (one compile) from the random tiny weights."""
    model, variables = jax_hrnet("tiny", 5)
    exp = _exp()
    state, tx = jax_create_state(model, exp, None, (1, 256, 192, 3),
                                 variables=variables)
    tx = _capture_grads(tx)
    state = state.replace(opt_state=tx.init(state.params))
    step = jax_train_step(model, tx, get_mesh(1), perceptual_cfg=exp,
                          donate=False)
    batches = [_batch(1), _batch(3)]
    s1, m1 = step(state, batches[0])
    s2, m2 = step(s1, batches[1])
    return dict(model=model, variables=variables, exp=exp, batches=batches,
                states=[jax.device_get(s) for s in (s1, s2)],
                metrics=[jax.device_get(m) for m in (m1, m2)])


def _params_close(port_model, jax_params, grads=None, tol=1e-6):
    """Each parameter within ``tol`` of its largest magnitude; with
    ``grads``, only where |g| > 1e-3 max|g| (Adam's first step is
    lr*sign(g) for |g| >> eps, so a gradient near zero decides it)."""
    ref = jax_variables_to_state_dict({"params": jax_params})
    mask = (None if grads is None else
            {k: np.abs(g) > 1e-3 * np.abs(g).max() for k, g in grads.items()})
    for k, p in port_model.named_parameters():
        got, want = p.detach().numpy(), ref[k].numpy()
        m = np.ones_like(got, bool) if mask is None else mask[k]
        assert m.any(), k
        assert _rel(got[m], want[m]) <= tol, (k, _rel(got[m], want[m]))


def test_train_step_matches_jax(jax_run):
    """Loss, every gradient, the BN running statistics, PCK and the
    updated parameters after one step."""
    exp, batch = jax_run["exp"], jax_run["batches"][0]
    s1, m1 = jax_run["states"][0], jax_run["metrics"][0]
    model = hrnet_from_jax(jax_run["variables"], HRNET_TINY, device="cpu")
    state = create_train_state(model, exp)
    metrics = make_train_step(perceptual_cfg=exp)(state, _to_port(batch))

    assert state.step == 1 and np.isfinite(m1["loss"])
    assert _rel(metrics["loss"].numpy(), m1["loss"]) <= 1e-5
    assert int(metrics["pck_hit"]) == int(m1["pck_hit"])
    assert int(metrics["pck_cnt"]) == int(m1["pck_cnt"]) > 0
    grads = {k: v.numpy() for k, v in jax_variables_to_state_dict(
        {"params": s1.opt_state[1]}).items()}
    for k, p in model.named_parameters():
        assert _rel(p.grad.numpy(), grads[k]) <= 1e-4, k
    stats = jax_variables_to_state_dict({"params": {},
                                         "batch_stats": s1.batch_stats})
    buffers = dict(model.named_buffers())
    for k, v in stats.items():
        assert _rel(buffers[k].numpy(), v.numpy()) <= 1e-5, k
    _params_close(model, s1.params, grads)


def test_second_step_from_converted_jax_state(jax_run):
    """``train_state_from_jax`` of JAX's state after step 1 (weights, BN
    statistics, Adam's moments and count, learning rate, step), then step
    2 on both sides."""
    exp, batch = jax_run["exp"], jax_run["batches"][1]
    s1, s2 = jax_run["states"]
    m2 = jax_run["metrics"][1]
    state = train_state_from_jax(s1.replace(opt_state=s1.opt_state[0]),
                                 HRNET_TINY, exp, device="cpu")
    assert state.step == 1
    assert port_optim.get_current_lr(state.optimizer) == pytest.approx(1e-3)
    metrics = make_train_step(perceptual_cfg=exp)(state, _to_port(batch))
    assert state.step == 2
    assert _rel(metrics["loss"].numpy(), m2["loss"]) <= 1e-5
    assert int(metrics["pck_hit"]) == int(m2["pck_hit"])
    grads = {k: v.numpy() for k, v in jax_variables_to_state_dict(
        {"params": s2.opt_state[1]}).items()}
    for k, p in state.model.named_parameters():
        assert _rel(p.grad.numpy(), grads[k]) <= 1e-4, k
    # Adam's second update divides each gradient by its own running RMS,
    # so the gradients' rounding reaches the parameters as ~lr times it
    _params_close(state.model, s2.params, grads, tol=1e-5)


def _random_grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(-4, 0))
        .astype(np.float32), params)


@pytest.mark.parametrize("optimizer,nesterov", [("adam", False),
                                                ("sgd", False),
                                                ("sgd", True)])
def test_optimizer_matches_optax_on_the_same_gradients(optimizer, nesterov):
    """Two updates from the same gradients: within 1e-6 of each
    parameter's largest magnitude."""
    model, variables = jax_hrnet("tiny", 3)
    exp = _exp(optimizer, nesterov=nesterov)
    params = variables["params"]
    tx = jax_optim.build_optimizer(exp)
    opt_state = tx.init(params)
    port = hrnet_from_jax(variables, HRNET_TINY, device="cpu")
    state = create_train_state(port, exp)
    for seed in (4, 5):
        grads = _random_grads(params, seed)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_grads = jax_variables_to_state_dict({"params": grads})
        for k, p in port.named_parameters():
            p.grad = port_grads[k]
        state.optimizer.step()
    _params_close(port, jax.device_get(params))


def test_eval_step_matches_jax(jax_run):
    """Eval-mode forward (running statistics), loss and PCK."""
    model, variables = jax_run["model"], jax_run["variables"]
    batch = jax_run["batches"][0]
    exp = jax_run["exp"]
    jstate, _ = jax_create_state(model, exp, None, (1, 256, 192, 3),
                                 variables=variables)
    ref_pred, ref = jax_eval_step(model, get_mesh(1))(jstate, batch)
    state = create_train_state(
        hrnet_from_jax(variables, HRNET_TINY, device="cpu"), exp)
    pred, metrics = make_eval_step()(state, _to_port(batch))
    assert _rel(pred.numpy(), ref_pred) <= 1e-5
    assert _rel(metrics["loss"].numpy(), ref["loss"]) <= 1e-5
    assert int(metrics["pck_hit"]) == int(ref["pck_hit"])
    assert int(metrics["pck_cnt"]) == int(ref["pck_cnt"])


def test_metric_accumulator_matches_jax():
    """Running sums, means and the non-finite guard."""
    steps = [{"loss": 0.5, "pck_hit": 3, "pck_cnt": 10},
             {"loss": float("nan"), "pck_hit": 4, "pck_cnt": 9},
             {"loss": 0.25, "pck_hit": 0, "pck_cnt": 11}]
    ref_acc, acc = JaxAccumulator(("loss",)), MetricAccumulator(("loss",))
    assert acc.empty and acc.fetch() == {"n": 0.0}
    for m in steps:
        ref_acc.update({k: jnp.asarray(v) for k, v in m.items()})
        acc.update({k: torch.tensor(v) for k, v in m.items()})
    ref, got = ref_acc.fetch(), acc.fetch()
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k]), k
    assert got["loss_n"] == 2.0 and got["loss_mean"] == pytest.approx(0.375)


@pytest.mark.parametrize("kind", ["plateau", "step"])
def test_scheduler_sequence_matches_jax(kind):
    """The same learning-rate sequence from one list of validation
    losses, and ``set_current_lr`` reaches the optimizer in place."""
    exp = _exp(scheduler=kind)
    ref, sched = jax_optim.build_scheduler(exp), port_optim.build_scheduler(exp)
    opt = port_optim.build_optimizer(exp, [torch.zeros(2,
                                                       requires_grad=True)])
    lr_ref = 1e-3
    for metric in (0.9, 0.8, 0.85, 0.7, 0.7, 0.6, 0.95, 0.5, 0.5, 0.4):
        lr_ref = ref.step(metric, lr_ref)
        port_optim.set_current_lr(
            opt, sched.step(metric, port_optim.get_current_lr(opt)))
        assert port_optim.get_current_lr(opt) == pytest.approx(lr_ref)
    assert lr_ref < 1e-3
    assert sched.state_dict() == ref.state_dict()
    assert port_optim.build_scheduler(_exp(scheduler="none")) is None


@pytest.mark.parametrize("training", [
    {}, {"lambda_D": 0.7, "lambda_P": 0.3}, {"perceptual_loss": False}])
def test_perceptual_loss_weighting_matches_jax(training):
    """The "add" scheme, the lambda-weighted sum, and off."""
    exp = _exp(**training)
    perc = np.float32([0.3, 1.2, 0.05, 2.0])
    ref = jax_loss.apply_perceptual_loss(exp, jnp.float32(0.8), perc)
    got = port_loss.apply_perceptual_loss(exp, torch.tensor(0.8), perc)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


def test_perceptual_loss_dict_read(tmp_path):
    exp = _exp()
    path = tmp_path / "perceptual_loss_dict_alpha_0.5_styles_all.json"
    path.write_text(json.dumps({"a.jpg": 0.25}))
    assert port_loss.load_perceptual_loss_dict(exp, str(tmp_path)) == \
        jax_loss.load_perceptual_loss_dict(exp, str(tmp_path))
    assert port_loss.load_perceptual_loss_dict(
        _exp(perceptual_loss=False), str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        port_loss.load_perceptual_loss_dict(exp, str(tmp_path / "none"))
