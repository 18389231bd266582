"""The port's flip-TTA eval and inference steps
(stlpose_tpu_torch/parallel/steps.py: ``make_eval_step(flip_tta)``,
``make_infer_fn``, ``make_eval_decode_step``) and PCK
(stlpose_tpu_torch/ops/pck.py) against stlpose_tpu's on a 1-device CPU
mesh, with the same HRNET_TINY weights (through
``models/convert.py::hrnet_from_jax``) and the same batch (B = 4).

Heatmaps within 1e-5 of their largest magnitude (f32 convolutions summed
in another order by XLA's and PyTorch's CPU backends, as in
tests/test_torch_hrnet.py), keypoints within 1e-3 px, loss within 1e-5
relative, PCK hits and counts exact. Stable because every combined
heatmap's peak is more than 1e-4 clear of its runner-up, and the
neighbour differences that pick the quarter-pixel shift are more than
1e-4 from zero (asserted first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops import pck as jax_pck
from stlpose_tpu.ops.heatmap import generate_targets as jax_targets
from stlpose_tpu.parallel.mesh import get_mesh
from stlpose_tpu.parallel import steps as jax_steps
from stlpose_tpu.train.state import create_train_state as jax_create_state
from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.models.convert import hrnet_from_jax
from stlpose_tpu_torch.ops import pck
from stlpose_tpu_torch.parallel import steps
from stlpose_tpu_torch.train.state import create_train_state
from tests.test_torch_hrnet import jax_hrnet
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B = 4
EXP = {"training": {"learning_rate": 1e-3, "optimizer": "adam"}}


def _batch(seed):
    rng = np.random.RandomState(seed)
    joints = rng.uniform(-10, 200, (B, 17, 2)).astype(np.float32)
    joints[..., 1] *= 256 / 192
    vis = (rng.rand(B, 17) > 0.2).astype(np.float32)
    target, weight = jax_targets(jnp.asarray(joints), jnp.asarray(vis))
    return {"image": rng.randn(B, 256, 192, 3).astype(np.float32),
            "target": np.asarray(target), "target_weight": np.asarray(weight),
            "center": rng.uniform(100, 500, (B, 2)).astype(np.float32),
            "scale": rng.uniform(0.5, 2.5, (B, 2)).astype(np.float32)}


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() /
                 np.abs(np.asarray(ref)).max())


def peak_margins(hm):
    """Of (N, J, H, W) heatmaps: every map's top-1 minus top-2 value, and,
    at the peaks strictly inside the border, the smaller of the two
    neighbour differences whose signs give the quarter-pixel shift."""
    N, J, H, W = hm.shape
    flat = hm.flatten(2)
    top2 = flat.topk(2, dim=-1).values
    idx = flat.argmax(-1)
    px, py = idx % W, idx // W
    inside = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
    n = torch.arange(N)[:, None]
    j = torch.arange(J)[None, :]
    pxc, pyc = px.clamp(1, W - 2), py.clamp(1, H - 2)
    dx = hm[n, j, pyc, pxc + 1] - hm[n, j, pyc, pxc - 1]
    dy = hm[n, j, pyc + 1, pxc] - hm[n, j, pyc - 1, pxc]
    return (top2[..., 0] - top2[..., 1],
            torch.minimum(dx.abs(), dy.abs())[inside])


@pytest.fixture(scope="module")
def scene():
    model, variables = jax_hrnet("tiny", 4)
    jstate, _ = jax_create_state(model, EXP, None, (1, 256, 192, 3),
                                 variables=variables)
    port = hrnet_from_jax(variables, HRNET_TINY, device="cpu")
    batch = _batch(6)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for flip in (True, False):
        gaps, shift_diffs = peak_margins(
            steps.make_infer_fn(port, flip, decode=False)(tb["image"]))
        assert gaps.min() > 1e-4 and len(shift_diffs) > 20, flip
        assert shift_diffs.min() > 1e-4, flip
    return model, jstate, port, batch, tb


@pytest.mark.parametrize("flip", [True, False])
def test_eval_step_matches_jax(scene, flip):
    model, jstate, port, batch, tb = scene
    ref_pred, ref = jax_steps.make_eval_step(model, get_mesh(1),
                                             flip_tta=flip)(jstate, batch)
    kw = {"flip_tta": flip} if flip else {}     # the old call keeps working
    pred, metrics = steps.make_eval_step(**kw)(
        create_train_state(port, EXP), tb)
    assert pred.shape == (B, 17, 64, 48) and pred.is_contiguous()
    assert _rel(pred.numpy(), ref_pred) <= 1e-5
    assert _rel(metrics["loss"].numpy(), ref["loss"]) <= 1e-5
    assert int(metrics["pck_hit"]) == int(ref["pck_hit"])
    assert int(metrics["pck_cnt"]) == int(ref["pck_cnt"]) > 0


@pytest.mark.parametrize("flip,decode", [(True, True), (True, False),
                                         (False, True)])
def test_infer_fn_matches_jax(scene, flip, decode):
    model, jstate, port, batch, tb = scene
    ref_fn = jax_steps.make_infer_fn(model, get_mesh(1), flip_tta=flip,
                                     decode=decode)
    fn = steps.make_infer_fn(port, flip_tta=flip, decode=decode)
    if not decode:
        ref_hm, hm = ref_fn(jstate, batch["image"]), fn(tb["image"])
    else:
        ref_kp, ref_hm = ref_fn(jstate, batch["image"], batch["center"],
                                batch["scale"])
        kp, hm = fn(tb["image"], tb["center"], tb["scale"])
        assert kp.shape == (B, 17, 3)
        np.testing.assert_allclose(kp[..., :2].numpy(),
                                   np.asarray(ref_kp)[..., :2],
                                   atol=1e-3, rtol=0)
        assert _rel(kp[..., 2].numpy(), np.asarray(ref_kp)[..., 2]) <= 1e-5
    assert _rel(hm.numpy(), ref_hm) <= 1e-5


@pytest.mark.parametrize("flip", [True, False])
def test_eval_decode_step_matches_jax(scene, flip):
    model, jstate, port, batch, tb = scene
    ref_kp, ref = jax_steps.make_eval_decode_step(
        model, get_mesh(1), flip_tta=flip)(jstate, batch)
    kp, metrics = steps.make_eval_decode_step(port, flip_tta=flip)(tb)
    np.testing.assert_allclose(kp[..., :2].numpy(),
                               np.asarray(ref_kp)[..., :2], atol=1e-3, rtol=0)
    assert _rel(kp[..., 2].numpy(), np.asarray(ref_kp)[..., 2]) <= 1e-5
    assert _rel(metrics["loss"].numpy(), ref["loss"]) <= 1e-5
    assert int(metrics["pck_hit"]) == int(ref["pck_hit"])
    assert int(metrics["pck_cnt"]) == int(ref["pck_cnt"]) > 0


def test_pck_accuracy_matches_jax(scene):
    """On the step's own flip-TTA heatmaps and targets (K1's plain version
    on the CPU), the device form and the numpy oracle, per joint."""
    _, _, port, batch, tb = scene
    pred = steps.make_infer_fn(port, decode=False)(tb["image"])
    ref = jax_pck.pck_accuracy(jnp.asarray(pred.numpy()),
                               jnp.asarray(batch["target"]))
    got = pck.pck_accuracy(pred, tb["target"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
    assert int(got[2]) == int(ref[2]) > 0
    ref_np = jax_pck.pck_accuracy_np(pred.numpy(), batch["target"])
    got_np = pck.pck_accuracy_np(pred.numpy(), batch["target"])
    assert got_np[0] == ref_np[0] and got_np[2] == ref_np[2]
    np.testing.assert_array_equal(got_np[1], ref_np[1])
