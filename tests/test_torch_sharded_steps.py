"""The port's steps data-parallel on two gloo ranks (stlpose_tpu_torch/
parallel/steps.py and detector_steps.py with a mesh, the global BatchNorm
statistics of models/hrnet.py::FlaxBatchNorm2d, the multi-process save
of utils/checkpoint.py).

One launch of two rank processes (tests/torch_ranks.py) runs every
sharded computation of the module; the tests compare its results with
the JAX package's ``make_train_step`` on a 2-device mesh of the conftest's
virtual CPU devices, and with the port's one-process runs here.

- Pose train step: HRNET_TINY weights (seed 5) converted from JAX
  variables, batches of 4 (seeds 1 and 3, those of
  tests/test_torch_train_step.py), 2 a rank, two Adam steps with the
  perceptual weighting; the JAX side's BatchNorm takes flax's two-pass
  variance, the port's (as tests/test_torch_detector_train.py). Bounds of
  that file: the loss within 1e-5, every gradient and BatchNorm statistic
  within 1e-4 of its largest magnitude, PCK counts equal, the parameters
  within 1e-6 (1e-5 after the second step) of their largest magnitude
  where the gradient is not near zero. Per-rank statistics (the
  BatchNorm group left unset) break those bounds.
- Eval, infer and eval-decode steps: each rank's rows gathered equal the
  one-process outputs within 1e-5 of their largest magnitude; the
  metrics (global) within 1e-6, PCK equal.
- Checkpoint: both ranks call ``save_checkpoint``; rank 0 writes one
  bundle, which loads here into a one-process state and equals the
  ranks' state exactly.
- Detector step: FASTER_RCNN_TINY (seeded init), a batch of 4 at
  128x128, 2 a rank, one SGD step on the sampling draws of one seeded
  generator against the port's one-process step: loss terms within 1e-5
  relative, parameters within 1e-4 of their largest magnitude. A NaN
  planted in one of rank 1's images makes the global loss non-finite:
  every rank's parameters stay put.
"""

import json

import flax.linen.normalization as flax_norm
import jax
import numpy as np
import pytest
import torch

from stlpose_tpu.parallel.mesh import get_mesh as jax_get_mesh
from stlpose_tpu.parallel.steps import make_train_step as jax_train_step
from stlpose_tpu.train.state import create_train_state as jax_create_state
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.convert import (hrnet_from_jax,
                                              jax_variables_to_state_dict,
                                              train_state_from_jax)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.parallel.detector_steps import \
    make_detector_train_step
from stlpose_tpu_torch.parallel.steps import (make_eval_decode_step,
                                              make_eval_step, make_infer_fn,
                                              make_train_step)
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_detector_train import two_pass_stats
from tests.test_torch_hrnet import jax_hrnet
from tests.test_torch_train_step import _batch, _capture_grads, _rel
from tests.test_torch_train_step import _exp as _step_exp
from tests.torch_ranks import launch, results
import tests.torch_threads  # noqa: F401  (caps torch's threads)

DET_EXP = {"training": {"learning_rate": 1e-2, "optimizer": "sgd",
                        "momentum": 0.9, "nesterov": False}}
DET_SEED, GEN_SEED = 0, 7

_BODY = """
import json
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.parallel.detector_steps import \\
    make_detector_train_step
from stlpose_tpu_torch.parallel.distributed import all_gather_host
from stlpose_tpu_torch.parallel.mesh import get_mesh, shard_batch
import stlpose_tpu_torch.parallel.steps as steps
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import save_checkpoint

ws = os.path.dirname(out)
cfg = json.load(open(os.path.join(ws, "cfg.json")))
weights = torch.load(os.path.join(ws, "weights.pt"))
data = dict(np.load(os.path.join(ws, "data.npz")))
batches = [{k[2:]: v for k, v in data.items() if k.startswith(f"{i}_")}
           for i in (0, 1)]
mesh = get_mesh(device="cpu")
assert mesh.size() == world and mesh.mesh_dim_names == ("data",)
shard = lambda b: shard_batch(mesh, b, "cpu")


def fresh():
    m = PoseHighResolutionNet(HRNET_TINY, "cpu")
    m.load_state_dict(weights)
    return create_train_state(m, cfg["exp"])


def clone(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


res = {"pose": []}
state = fresh()
step = steps.make_train_step(perceptual_cfg=cfg["exp"], mesh=mesh)
for b in batches:
    m = step(state, shard(b))
    res["pose"].append({
        "metrics": {k: v.item() for k, v in m.items()},
        "grads": {k: p.grad.clone() for k, p in
                  state.model.named_parameters()},
        "state": clone(state.model)})
save_checkpoint(state, ws, 1)

# eval, infer and eval-decode on the weights as loaded
model = fresh().model
b = batches[0]
hm, met = steps.make_eval_step(flip_tta=True, mesh=mesh)(
    fresh(), shard(b))
preds, _ = steps.make_infer_fn(model, flip_tta=True, mesh=mesh)(
    *shard([b["image"], b["center"], b["scale"]]))
kp, met2 = steps.make_eval_decode_step(model, mesh=mesh)(shard(
    {k: b[k] for k in ("image", "target", "target_weight", "center",
                       "scale")}))
res["eval"] = {"local_rows": hm.shape[0], **all_gather_host(
    {"hm": hm.numpy(), "preds": preds.numpy(), "kp": kp.numpy()}),
    "metrics": {k: v.item() for k, v in met.items()},
    "decode_metrics": {k: v.item() for k, v in met2.items()}}

# the detector step, then one on a batch with a NaN in a rank-1 image
torch.manual_seed(cfg["det_seed"])
det = FasterRCNN(FASTER_RCNN_TINY, "cpu")
dstate = create_train_state(det, cfg["det_exp"])
dstep = make_detector_train_step(mesh=mesh)
gen = torch.Generator().manual_seed(cfg["gen_seed"])
dbatch = {k[4:]: v for k, v in data.items() if k.startswith("det_")}
dm = dstep(dstate, shard(dbatch), gen)
res["det"] = {"metrics": {k: v.item() for k, v in dm.items()},
              "params": {k: p.detach().clone()
                         for k, p in det.named_parameters()}}
bad = dict(dbatch, image=dbatch["image"].copy())
bad["image"][3, 5, 5, 0] = np.nan
dm = dstep(dstate, shard(bad), gen)
res["det_nan"] = {"metrics": {k: v.item() for k, v in dm.items()},
                  "params": {k: p.detach().clone()
                             for k, p in det.named_parameters()},
                  "planted_here": bool(np.isnan(
                      shard(bad)["image"].numpy()).any())}

# the second step from the JAX package's state after the first
state = fresh()
state.model.load_state_dict(torch.load(os.path.join(ws, "jax_s1.pt")))
state.optimizer.load_state_dict(torch.load(os.path.join(ws, "jax_s1_opt.pt")))
state.step = 1
m = step(state, shard(batches[1]))
res["pose_from_jax"] = {
    "metrics": {k: v.item() for k, v in m.items()},
    "grads": {k: p.grad.clone() for k, p in state.model.named_parameters()},
    "state": clone(state.model)}

# per-rank statistics: the BatchNorm group left unset (last: the detector
# step takes its group through the same function)
steps.set_batchnorm_group = lambda module, group: module
state = fresh()
m = steps.make_train_step(perceptual_cfg=cfg["exp"], mesh=mesh)(
    state, shard(batches[0]))
res["local_stats"] = {
    "metrics": {k: v.item() for k, v in m.items()},
    "grads": {k: p.grad.clone() for k, p in state.model.named_parameters()},
    "state": clone(state.model)}
save(res)
"""


def _det_batch(seed=2, n=4, k=4):
    rng = np.random.RandomState(seed)
    img = rng.rand(n, 128, 128, 3).astype(np.float32)
    boxes = np.zeros((n, k, 4), np.float32)
    mask = np.zeros((n, k), np.float32)
    labels = np.zeros((n, k), np.int32)
    for b in range(n):
        for j in range(1 + b % 3):
            xy = rng.uniform(0, 80, 2)
            wh = rng.uniform(16, 60, 2)
            boxes[b, j] = [xy[0], xy[1], min(xy[0] + wh[0], 128.0),
                           min(xy[1] + wh[1], 128.0)]
            mask[b, j], labels[b, j] = 1.0, 1
    return {"image": img, "boxes": boxes, "labels": labels, "box_mask": mask,
            "perceptual_loss": np.zeros((n,), np.float32)}


def _pose_batches():
    out = []
    for seed in (1, 3):
        b = _batch(seed)
        rng = np.random.RandomState(seed + 10)
        b["center"] = rng.uniform(100, 300, (4, 2)).astype(np.float32)
        b["scale"] = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, the JAX reference's two steps on a 2-device
    mesh and what the tests share."""
    ws = tmp_path_factory.mktemp("sharded_steps")
    jmodel, variables = jax_hrnet("tiny", 5)
    exp = _step_exp()
    port = hrnet_from_jax(variables, HRNET_TINY, device="cpu")
    torch.save(port.state_dict(), ws / "weights.pt")
    batches = _pose_batches()
    det = _det_batch()
    np.savez(ws / "data.npz",
             **{f"{i}_{k}": v for i, b in enumerate(batches)
                for k, v in b.items()},
             **{f"det_{k}": v for k, v in det.items()})
    (ws / "cfg.json").write_text(json.dumps(
        {"exp": exp, "det_exp": DET_EXP, "det_seed": DET_SEED,
         "gen_seed": GEN_SEED}))

    state, tx = jax_create_state(jmodel, exp, None, (1, 256, 192, 3),
                                 variables=variables)
    tx = _capture_grads(tx)
    state = state.replace(opt_state=tx.init(state.params))
    step = jax_train_step(jmodel, tx, jax_get_mesh(2), perceptual_cfg=exp,
                          donate=False)
    jax_states, jax_metrics = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass_stats)
        for b in batches:
            state, m = step(state, {k: v for k, v in b.items()
                                    if k not in ("center", "scale")})
            jax_states.append(jax.device_get(state))
            jax_metrics.append(jax.device_get(m))
    s1 = jax_states[0]
    s1 = train_state_from_jax(s1.replace(opt_state=s1.opt_state[0]),
                              HRNET_TINY, exp, device="cpu")
    torch.save(s1.model.state_dict(), ws / "jax_s1.pt")
    torch.save(s1.optimizer.state_dict(), ws / "jax_s1_opt.pt")

    launch(ws, _BODY, timeout=400)
    return dict(ws=ws, ranks=results(ws), exp=exp, batches=batches,
                det=det, weights=port.state_dict(), jax_states=jax_states,
                jax_metrics=jax_metrics)


def _jax_tensors(jstate):
    """(gradients, parameters, BatchNorm statistics) of a JAX state, in
    the port's names."""
    grads = jax_variables_to_state_dict({"params": jstate.opt_state[1]})
    params = jax_variables_to_state_dict({"params": jstate.params})
    stats = jax_variables_to_state_dict({"params": {},
                                         "batch_stats": jstate.batch_stats})
    return grads, params, stats


def _worst(got: dict, ref: dict):
    return max(_rel(got[k].numpy(), ref[k].numpy()) for k in ref)


def _params_close(got, want, grads, tol):
    """Each parameter within ``tol`` of its largest magnitude where |g| >
    1e-3 max|g| (Adam's update is about lr*sign(g), so a gradient near
    zero decides it; tests/test_torch_train_step.py)."""
    for k, g in grads.items():
        g = g.numpy()
        m = np.abs(g) > 1e-3 * np.abs(g).max()
        assert m.any(), k
        assert _rel(got[k].numpy()[m], want[k].numpy()[m]) <= tol, k


def _check_pose_step(res, jstate, jmetrics, tol):
    grads, params, stats = _jax_tensors(jstate)
    assert _rel(res["metrics"]["loss"], jmetrics["loss"]) <= 1e-5
    assert res["metrics"]["pck_hit"] == int(jmetrics["pck_hit"])
    assert res["metrics"]["pck_cnt"] == int(jmetrics["pck_cnt"]) > 0
    assert _worst(res["grads"], grads) <= 1e-4
    assert _worst(res["state"], stats) <= 1e-4
    _params_close(res["state"], params, grads, tol)


@pytest.mark.parametrize("i", [0, 1])
def test_pose_step_matches_jax_on_a_two_device_mesh(run, i):
    """Each of the two steps, on rank 0's results: loss, PCK, every
    gradient, the BatchNorm running statistics and the parameters. The
    second starts from the JAX state after the first (converted by
    ``train_state_from_jax``), as in tests/test_torch_train_step.py: from
    the port's own first step a ReLU input of the second lies within
    rounding of zero and its gradient flips between the backends."""
    res = run["ranks"][0]["pose_from_jax" if i else "pose"]
    if not i:
        res = res[0]
    _check_pose_step(res, run["jax_states"][i], run["jax_metrics"][i],
                     # Adam's second update divides each gradient by its
                     # own running RMS: the gradients' rounding reaches the
                     # parameters as ~lr times it
                     tol=1e-5 if i else 1e-6)


def test_ranks_hold_the_same_state(run):
    """The replicated state: both ranks' metrics and tensors are equal
    bit for bit after every step."""
    r0, r1 = run["ranks"]
    for a, b in zip(r0["pose"], r1["pose"]):
        assert a["metrics"] == b["metrics"]
        for k in a["state"]:
            assert torch.equal(a["state"][k], b["state"][k]), k


def test_per_rank_statistics_would_break_the_bound(run):
    """The same first step with each rank's BatchNorm on its own 2 crops:
    the running statistics and the gradients leave the bounds that the
    global statistics meet."""
    res = run["ranks"][0]["local_stats"]
    grads, _, stats = _jax_tensors(run["jax_states"][0])
    assert _worst(res["state"], stats) > 1e-2
    assert _worst(res["grads"], grads) > 1e-2
    assert _rel(res["metrics"]["loss"], run["jax_metrics"][0]["loss"]) > 1e-5


def test_two_ranks_match_the_one_process_port(run):
    """The port on 2 ranks against itself on 1: the first step from the
    weights, the second from the JAX state after the first (as above:
    Adam turns the rounding of a gradient near zero into an O(lr) update,
    which the second step's gradients would carry)."""
    model = PoseHighResolutionNet(HRNET_TINY, "cpu")
    model.load_state_dict(run["weights"])
    state = create_train_state(model, run["exp"])
    step = make_train_step(perceptual_cfg=run["exp"])
    ranks = run["ranks"][0]
    for i, (b, res) in enumerate(zip(run["batches"], (
            ranks["pose"][0], ranks["pose_from_jax"]))):
        if i:
            model.load_state_dict(torch.load(run["ws"] / "jax_s1.pt"))
            state.optimizer.load_state_dict(
                torch.load(run["ws"] / "jax_s1_opt.pt"))
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert _rel(res["metrics"]["loss"], m["loss"].item()) <= 1e-5
        assert res["metrics"]["pck_hit"] == m["pck_hit"].item()
        grads = {k: p.grad for k, p in model.named_parameters()}
        assert _worst(res["grads"], grads) <= 1e-4
        stats = {k: v for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        assert _worst(res["state"], stats) <= 1e-4
        _params_close(res["state"], {k: p.detach() for k, p in
                                     model.named_parameters()},
                      {k: g.detach() for k, g in grads.items()},
                      1e-5 if i else 1e-6)


def test_eval_and_infer_steps_gathered_match_one_process(run):
    model = PoseHighResolutionNet(HRNET_TINY, "cpu")
    model.load_state_dict(run["weights"])
    b = {k: torch.from_numpy(v) for k, v in run["batches"][0].items()}
    hm, met = make_eval_step(flip_tta=True)(
        create_train_state(model, run["exp"]), b)
    preds, _ = make_infer_fn(model, flip_tta=True)(b["image"], b["center"],
                                                   b["scale"])
    kp, met2 = make_eval_decode_step(model)(b)
    for res in (r["eval"] for r in run["ranks"]):
        assert res["local_rows"] == 2
        assert _rel(res["hm"], hm.numpy()) <= 1e-5
        assert _rel(res["preds"][..., 2], preds[..., 2].numpy()) <= 1e-5
        np.testing.assert_allclose(res["preds"][..., :2],
                                   preds[..., :2].numpy(), atol=1e-3)
        np.testing.assert_allclose(res["kp"], kp.numpy(), atol=1e-3)
        for got, want in ((res["metrics"], met),
                          (res["decode_metrics"], met2)):
            assert _rel(got["loss"], want["loss"].item()) <= 1e-6
            assert got["pck_hit"] == want["pck_hit"].item()
            assert got["pck_cnt"] == want["pck_cnt"].item()


def test_checkpoint_from_two_ranks_restores_in_one_process(run):
    ws = run["ws"]
    assert sorted(p.name for p in (ws / "models").iterdir()) == [
        "checkpoint_epoch_1.meta.json", "checkpoint_epoch_1.pt"]
    model = PoseHighResolutionNet(HRNET_TINY, "cpu")
    state = create_train_state(model, run["exp"])
    state, epoch = load_checkpoint(state, str(ws), 1)
    assert epoch == 1 and state.step == 2
    want = run["ranks"][1]["pose"][1]["state"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.fixture(scope="module")
def one_process_detector(run):
    """The port's one-process detector step and NaN step on the same
    draws."""
    torch.manual_seed(DET_SEED)
    det = FasterRCNN(FASTER_RCNN_TINY, "cpu")
    state = create_train_state(det, DET_EXP)
    step = make_detector_train_step()
    gen = torch.Generator().manual_seed(GEN_SEED)
    batch = {k: torch.from_numpy(v) for k, v in run["det"].items()}
    m = step(state, batch, gen)
    params = {k: p.detach().clone() for k, p in det.named_parameters()}
    return {k: v.item() for k, v in m.items()}, params


def test_detector_step_matches_one_process(run, one_process_detector):
    metrics, params = one_process_detector
    for res in (r["det"] for r in run["ranks"]):
        assert res["metrics"]["finite"] == 1.0
        for k, v in metrics.items():
            assert _rel(res["metrics"][k], v) <= 1e-5, k
        assert _worst(res["params"], params) <= 1e-4


def test_a_non_finite_loss_on_one_rank_keeps_every_rank_put(run):
    """The NaN sits in rank 1's rows only; the global loss is not finite
    on both ranks, and neither moves its parameters."""
    assert [r["det_nan"]["planted_here"] for r in run["ranks"]] == \
        [False, True]
    for r in run["ranks"]:
        assert r["det_nan"]["metrics"]["finite"] == 0.0
        assert not np.isfinite(r["det_nan"]["metrics"]["loss"])
        for k, v in r["det"]["params"].items():
            assert torch.equal(r["det_nan"]["params"][k], v), k
