"""The port's training engine (stlpose_tpu_torch/engines/trainer.py) and
its bf16 policy, against the JAX package.

- Trainer parity: the JAX and the port ``PoseTrainer`` on the same
  synthetic COCO data (16 train crops, 2 batches of 8; 8 valid crops),
  device-warp batches without rotation, one reference-format ``.pth``
  (tests/torch_hrnet.py), ``config_name="tiny"``, two epochs, one decode
  worker each (the augmentation draws then come in record order), the
  JAX step on a 1-device mesh. On the CPU the JAX pipeline crops with
  XLA's direct gather and the port with K4's plain two-pass version;
  unrotated, both are bilinear and differ by ~1e-6.

  Bounds, as measured here: the per-epoch losses in training_logs.json
  within 1e-4 relative (readings 1.3e-7 to 2.3e-5: the steps' rounding,
  1e-5 on the forward and 1e-4 on the gradients
  (tests/test_torch_train_step.py), grows over four steps), accuracies
  equal; BatchNorm statistics within 1e-3 of each tensor's largest value
  (reading 1.3e-4); each parameter tensor's change over the run within
  0.2 of its largest change (readings: median 1e-3, largest 0.065, in
  convolutions fed by ReLUs whose inputs lie within rounding of zero,
  whose gradients flip between the backends). The run uses SGD: Adam's
  per-entry normalisation turns the backends' rounding of a small
  gradient into an O(1) difference of its update (at lr 1e-3 over the
  same four steps: epoch 1's valid loss 9e-4 apart, 53% of the updates
  more than 0.1 lr apart). Adam's own update is held on equal gradients
  by test_torch_train_step.py.
- Resume from the port's checkpoint 1: epoch, step, learning rate,
  scheduler state, weights and the optimizer's buffers.
- bf16 training: parameters, gradients, Adam's moments and checkpoints
  stay f32; one bf16 train step against JAX's bf16 step on the same
  ``.pth`` and batch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stlpose_tpu.engines.trainer as jax_trainer_module
from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.engines import PoseTrainer as JaxPoseTrainer
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu.parallel.mesh import get_mesh
from stlpose_tpu.parallel.steps import make_train_step as jax_train_step
from stlpose_tpu.train.optim import get_current_lr as jax_current_lr
from stlpose_tpu.train.state import create_train_state as jax_create_state
from stlpose_tpu.train.state import param_count as jax_param_count
from stlpose_tpu.utils.checkpoint import \
    load_pretrained_variables as jax_load_pth
from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.engines import PoseTrainer
from stlpose_tpu_torch.models.convert import (jax_variables_to_state_dict,
                                              load_torch_statedict,
                                              torch_statedict_to_port)
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.parallel.steps import make_train_step
from stlpose_tpu_torch.train.optim import get_current_lr
from stlpose_tpu_torch.train.state import create_train_state, param_count
from stlpose_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_pretrained_variables)
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.fixtures import make_coco_dataset
from tests.test_torch_pose_evaluator import _write_pth
from tests.test_torch_train_step import _batch, _capture_grads, _to_port
from tests.test_torch_train_step import _exp as _step_exp
import tests.torch_threads  # noqa: F401  (caps torch's threads)

TRAIN = {"batch_size": 8, "num_epochs": 2, "save_frequency": 1,
         "optimizer": "sgd", "learning_rate": 1e-3, "scheduler": "plateau",
         "patience": 0, "scale_factor": 0.25, "rot_factor": 0,
         "flip": True, "prob_half_body": 0.3, "device_warp": True}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers, two epochs each, from one ``.pth``."""
    root = tmp_path_factory.mktemp("trainer")
    data = str(root / "data")
    make_coco_dataset(data, n_train=8, n_val=4)
    pth = str(root / "tiny.pth")
    _write_pth(pth)
    out = {"data": data, "pth": pth}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "get_mesh", lambda: get_mesh(1))
        for tag, cls, kw in (("jax", JaxPoseTrainer, {}),
                             ("port", PoseTrainer, {"device": "cpu"})):
            exp_path = create_experiment(tag, TRAIN,
                                         root=str(root / "experiments"))
            tr = cls(exp_path, data_path=data, num_workers=1,
                     make_plots=False, **kw)
            tr.load_dataset()
            tr.setup_model(config_name="tiny", pretrained=pth)
            tr.training_loop()
            out[tag] = tr
    return out


def _logs(trainer):
    with open(os.path.join(trainer.exp_path, "training_logs.json")) as f:
        return json.load(f)


def test_trainer_matches_jax(runs):
    ref, got = _logs(runs["jax"]), _logs(runs["port"])
    assert got["iterations"] == ref["iterations"] == 4
    for key in ("loss", "accuracy"):
        for split in ("training", "validation"):
            r, g = np.asarray(ref[key][split]), np.asarray(got[key][split])
            assert r.shape == g.shape == (2,) and np.isfinite(g).all()
            if key == "loss":
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=0)
            else:
                np.testing.assert_array_equal(g, r)
    # the plateau scheduler stepped the same way on both sides
    lr = get_current_lr(runs["port"].state.optimizer)
    assert lr == pytest.approx(jax_current_lr(runs["jax"].state.opt_state))
    assert lr < TRAIN["learning_rate"]

    final = jax_variables_to_state_dict(
        jax.device_get(runs["jax"].state.variables()))
    start = torch_statedict_to_port(load_torch_statedict(runs["pth"]))
    params = dict(runs["port"].model.named_parameters())
    for k, v in runs["port"].model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        want = final[k]
        if k in params:
            moved, moved_ref = v - start[k], want - start[k]
            assert float(moved_ref.abs().max()) > 0, k
            err = float((moved - moved_ref).abs().max() /
                        moved_ref.abs().max())
            assert err <= 0.2, (k, err)
        else:
            err = float((v - want).abs().max() / want.abs().max())
            assert err <= 1e-3, (k, err)
    assert param_count(runs["port"].state) == \
        jax_param_count(runs["jax"].state)


def test_trainer_writes_the_experiment(runs):
    """Checkpoints of epochs 0 and 1 and the final one, the StepTimer
    stats of each train epoch, TensorBoard scalars."""
    exp_path = runs["port"].exp_path
    for label in ("0", "1", "final"):
        assert os.path.exists(checkpoint_path(exp_path, label) + ".pt")
    with open(os.path.join(exp_path, "timing_logs.json")) as f:
        timing = json.load(f)
    assert [sorted(s) for s in timing["train_epoch"]] == \
        [["examples_per_sec", "steps_per_sec"]] * 2
    assert os.listdir(os.path.join(exp_path, "tboard_logs"))


def test_resume_restores_the_training_state(runs):
    """From checkpoint 1 (written after the last epoch, so equal to the
    run's final state): the epoch, the step count, the learning rate,
    the scheduler, the weights and SGD's momentum buffers."""
    done = runs["port"]
    tr = PoseTrainer(done.exp_path, checkpoint="1", resume_training=True,
                     data_path=runs["data"], num_workers=1,
                     make_plots=False, device="cpu")
    tr.load_dataset()
    tr.setup_model(config_name="tiny", pretrained=None)
    assert tr.cur_epoch == 1
    assert tr.state.step == done.state.step == 4
    assert get_current_lr(tr.state.optimizer) == \
        get_current_lr(done.state.optimizer) < TRAIN["learning_rate"]
    assert tr.scheduler.state_dict() == done.scheduler.state_dict()
    for (k, a), b in zip(tr.model.state_dict().items(),
                         done.model.state_dict().values()):
        assert torch.equal(a, b), k
    got = tr.state.optimizer.state_dict()["state"]
    for i, s in done.state.optimizer.state_dict()["state"].items():
        assert torch.equal(got[i]["momentum_buffer"], s["momentum_buffer"])
    # weights only, without --resume_training: epoch 0, no optimizer state
    fresh = PoseTrainer(done.exp_path, checkpoint="1", data_path=runs["data"],
                        num_workers=1, make_plots=False, device="cpu")
    fresh.load_dataset()
    fresh.setup_model(config_name="tiny", pretrained=None)
    assert fresh.cur_epoch == 0 and fresh.state.step == 0
    assert not fresh.state.optimizer.state_dict()["state"]
    assert torch.equal(fresh.model.stem1.conv.weight,
                       done.model.stem1.conv.weight)


def _spread(a: dict, b: dict, scale: dict) -> float:
    """Distance of ``a`` from ``b`` over every entry, each tensor divided
    by its largest magnitude in ``scale``."""
    total = 0.0
    for k in b:
        n = float(scale[k].abs().max()) or 1.0
        total += float(((a[k].float() - b[k].float()) / n).square().sum())
    return total ** 0.5


def test_bf16_train_step_matches_jax(tmp_path):
    """One Adam step of HRNET_TINY in bf16 compute (perceptual weighting
    on, B = 4) from one ``.pth``. Parameters, gradients and Adam's
    moments are f32. Bound, in the style of tests/test_torch_bf16.py: E,
    the JAX bf16 step's distance from the port's f32 step (which equals
    JAX's f32 step to 1e-5, test_torch_train_step.py), must be positive;
    the port's bf16 step lies within 2E of JAX's bf16 step, for the loss,
    the gradients, the parameters' updates and the BatchNorm statistics
    (each tensor divided by its largest magnitude, summed over all
    entries). Readings here: loss 0.68E (E = 2.7e-4 of the loss),
    gradients 1.12E, BatchNorm statistics 0.56E."""
    pth = str(tmp_path / "tiny.pth")
    _write_pth(pth)
    exp, batch = _step_exp(), _batch(1)
    jmodel = JaxHRNet(config=jax_hrnet_config("tiny"), dtype=jnp.bfloat16)
    jstate, tx = jax_create_state(jmodel, exp, None, (1, 256, 192, 3),
                                  variables=jax_load_pth(jmodel, pth))
    tx = _capture_grads(tx)
    jstate = jstate.replace(opt_state=tx.init(jstate.params))
    s1, m1 = jax.device_get(jax_train_step(
        jmodel, tx, get_mesh(1), perceptual_cfg=exp,
        donate=False)(jstate, batch))
    assert jax.tree_util.tree_leaves(s1.params)[0].dtype == jnp.float32
    ref_grads = jax_variables_to_state_dict({"params": s1.opt_state[1]})
    ref = jax_variables_to_state_dict({"params": s1.params,
                                       "batch_stats": s1.batch_stats})

    def port_step(dtype):
        model = PoseHighResolutionNet(HRNET_TINY, "cpu", dtype,
                                      param_dtype=torch.float32)
        start = load_pretrained_variables(model, pth)
        state = create_train_state(model, exp)
        metrics = make_train_step(perceptual_cfg=exp)(state, _to_port(batch))
        return state, metrics, start

    s16, m16, start = port_step(torch.bfloat16)
    s32, m32, _ = port_step(torch.float32)
    model = s16.model
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    assert {t.dtype for s in s16.optimizer.state.values()
            for t in s.values()} == {torch.float32}

    e_loss = abs(float(m1["loss"]) - float(m32["loss"]))
    assert 0 < e_loss <= 0.05 * abs(float(m32["loss"]))
    assert abs(float(m16["loss"]) - float(m1["loss"])) <= 2 * e_loss
    assert int(m16["pck_cnt"]) == int(m1["pck_cnt"]) > 0

    named = dict(model.named_parameters())
    g16 = {k: p.grad for k, p in named.items()}
    g32 = {k: p.grad for k, p in s32.model.named_parameters()}
    e = _spread(ref_grads, g32, g32)
    assert e > 0 and _spread(g16, ref_grads, g32) <= 2 * e
    up16 = {k: p.detach() - start[k] for k, p in named.items()}
    up32 = {k: p.detach() - start[k]
            for k, p in s32.model.named_parameters()}
    upj = {k: ref[k] - start[k] for k in named}
    e = _spread(upj, up32, up32)
    assert e > 0 and _spread(up16, upj, up32) <= 2 * e
    keep = [k for k, _ in model.named_buffers()
            if not k.endswith("num_batches_tracked")]
    b16, b32 = dict(model.named_buffers()), dict(s32.model.named_buffers())
    stats = {k: ref[k] for k in keep}
    e = _spread(stats, {k: b32[k] for k in keep}, b32)
    assert e > 0 and _spread({k: b16[k] for k in keep}, stats, b32) <= 2 * e


def test_bf16_trainer_keeps_f32_weights_and_checkpoints(runs, tmp_path):
    """The trainer in bf16: one epoch leaves every parameter and Adam
    moment f32 and writes f32 checkpoints; the bf16 serving model stores
    its convolutions in bf16."""
    exp_path = create_experiment("bf16", {**TRAIN, "num_epochs": 1,
                                          "optimizer": "adam"},
                                 root=str(tmp_path))
    tr = PoseTrainer(exp_path, data_path=runs["data"], num_workers=1,
                     make_plots=False, dtype=torch.bfloat16, device="cpu")
    tr.load_dataset()
    tr.setup_model(config_name="tiny", pretrained=runs["pth"])
    assert tr.model.stem1.conv.weight.dtype == torch.float32
    tr.training_loop()
    assert np.isfinite(_logs(tr)["loss"]["training"]).all()
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    assert {t.dtype for s in tr.state.optimizer.state.values()
            for t in s.values()} == {torch.float32}
    blob = torch.load(checkpoint_path(exp_path, "final") + ".pt",
                      weights_only=True)
    assert {v.dtype for k, v in blob["model_state_dict"].items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
    serving = PoseHighResolutionNet(HRNET_TINY, "cpu", torch.bfloat16)
    assert serving.stem1.conv.weight.dtype == torch.bfloat16


def test_trainer_refuses_the_card_without_one(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseTrainer(runs["port"].exp_path)


def test_bf16_stored_weights_would_lose_the_updates(tmp_path):
    """Why training builds f32 master weights: one Adam step at lr 1e-5 on
    bf16-stored convolutions (the serving flavor's storage) rounds away
    most updates, which are below half a bf16 step of their weights; on
    f32 master weights every update lands."""
    pth = str(tmp_path / "tiny.pth")
    _write_pth(pth)
    exp = _step_exp(learning_rate=1e-5)
    batch = _to_port(_batch(1))
    moved = {}
    for label, param_dtype in (("stored", None), ("master", torch.float32)):
        model = PoseHighResolutionNet(HRNET_TINY, "cpu", torch.bfloat16,
                                      param_dtype=param_dtype)
        load_pretrained_variables(model, pth)
        before = model.stem2.conv.weight.detach().clone()
        make_train_step(perceptual_cfg=exp)(create_train_state(model, exp),
                                            batch)
        moved[label] = float((model.stem2.conv.weight != before)
                             .float().mean())
    print("share of stem2's weights moved:", moved)
    assert moved["master"] == 1.0
    assert moved["stored"] < 0.1, moved
