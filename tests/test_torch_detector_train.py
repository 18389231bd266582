"""Detector training: the PyTorch port (stlpose_tpu_torch/models/
faster_rcnn.py's training half, parallel/detector_steps.py) against the
JAX package's FasterRCNN.loss_fn and make_detector_train_step on
FASTER_RCNN_TINY, the same weights (carried across by models/convert.py)
and the same random draws: the tests rebuild the JAX sampling's uniforms
(rng -> split(rng, 2N) -> per image [0] RPN, [1] RoI -> split -> r1, r2
-> uniform) and hand them to the port, so the sampling is the same.

The reference's train-mode BatchNorm statistics are taken here with
flax's two-pass variance (``use_fast_variance=False``: the same biased
variance, E[(x - E[x])^2]) instead of its default one pass, E[x^2] -
E[x]^2, whose cancellation moves the reference's own train-mode features
by ~1e-4 relative on these weights (the stem's normalised output 9.2e-6
from a float64 evaluation, the port's 4.2e-7). With the one-pass form the
classifier loss read 1.1e-5 relative from the port's and the gradients
6.6e-3 of their max abs (the reference against itself on the image
perturbed by 1e-6 relative: 3.1e-3), which no port could meet; with the
two-pass form they read 5.8e-7 and 1.9e-5. The patch is undone when the
module's reference computations end.
"""

import copy

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import faster_rcnn as jfr
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu.parallel import get_mesh
from stlpose_tpu.parallel.detector_steps import \
    make_detector_train_step as jax_train_step
from stlpose_tpu.train.state import create_train_state as jax_train_state
from stlpose_tpu_torch.config import FASTER_RCNN_TINY
from stlpose_tpu_torch.models import faster_rcnn as pfr
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.parallel.detector_steps import \
    make_detector_train_step
from stlpose_tpu_torch.train.state import create_train_state
from tests.test_torch_hrnet import random_variables
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B, K = 2, 4
EXP = {"training": {"learning_rate": 1e-5, "optimizer": "adam",
                    "perceptual_loss": True},
       "dataset": {"dataset_name": "styled_coco"}}
T = torch.from_numpy


def two_pass_stats(*args, **kw):
    kw["use_fast_variance"] = False
    return TWO_PASS_ORIG(*args, **kw)


TWO_PASS_ORIG = flax_norm._compute_stats


def make_batch(seed=1):
    """B images of the tiny canvas with 3 and 2 person boxes (K = 4
    slots, the rest padding)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(B, 128, 128, 3).astype(np.float32)
    boxes = np.zeros((B, K, 4), np.float32)
    mask = np.zeros((B, K), np.float32)
    labels = np.zeros((B, K), np.int32)
    for b in range(B):
        for k in range(3 - b):
            xy = rng.uniform(0, 80, 2)
            wh = rng.uniform(16, 60, 2)
            boxes[b, k] = [xy[0], xy[1], min(xy[0] + wh[0], 128.0),
                           min(xy[1] + wh[1], 128.0)]
            mask[b, k], labels[b, k] = 1.0, 1
    return {"image": img, "boxes": boxes, "labels": labels, "box_mask": mask,
            "perceptual_loss": np.zeros((B,), np.float32)}


def jax_draws(key, n):
    r1, r2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(r1, (n,))),
            np.asarray(jax.random.uniform(r2, (n,))))


def port_uniforms(rng, n_anchors, n_pool):
    """The uniforms that FasterRCNN.loss_fn(rng) draws, as loss_fn's
    ``uniforms`` argument."""
    rngs = jax.random.split(rng, B * 2).reshape(B, 2, -1)
    out = {}
    for j, (name, n) in enumerate((("rpn", n_anchors), ("roi", n_pool))):
        d = [jax_draws(rngs[i, j], n) for i in range(B)]
        out[name] = tuple(T(np.stack([x[u] for x in d])) for u in range(2))
    return out


def torch_batch(batch):
    return {k: T(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """Every reference computation of the module, under the two-pass
    statistics: loss_fn's value and gradient, its train-mode forward, and
    three make_detector_train_step steps (finite, non-finite, finite)."""
    det = JaxFasterRCNN(JAX_TINY, pallas_roi=False)
    abstract = jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0)))
    variables = random_variables(abstract, 0)
    batch = make_batch()
    jbatch = {k: v for k, v in batch.items() if k != "perceptual_loss"}
    key = jax.random.PRNGKey(7)
    out = {"det": det, "variables": variables, "batch": batch, "key": key}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass_stats)

        def loss(params, stats, b, k):
            return det.loss_fn({"params": params, "batch_stats": stats}, b,
                               k)

        (total, (terms, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"],
                                 variables["batch_stats"], jbatch, key)
        out.update(total=float(total),
                   terms={k: float(v) for k, v in terms.items()},
                   stats=jax.device_get(stats), grads=jax.device_get(grads))
        (feats, logits, deltas), _ = det.module.apply(
            variables, batch["image"], train=True, mutable=["batch_stats"])
        out.update(logits=[np.array(x) for x in logits],
                   deltas=[np.array(x) for x in deltas],
                   anchors=[np.array(a) for a in det._get_anchors(logits)])

        state, tx = jax_train_state(None, EXP, None, None,
                                    variables=variables)
        step = jax_train_step(det, tx, get_mesh(1), perceptual_cfg=EXP,
                              donate=False)
        bad = dict(batch, perceptual_loss=np.full((B,), np.inf, np.float32))
        keys = jax.random.split(jax.random.PRNGKey(11), 3)
        trajectory = []
        for b, k in zip((batch, bad, batch), keys):
            state, metrics = step(state, b, k)
            trajectory.append((jax.device_get(state),
                               {m: float(v) for m, v in metrics.items()}))
        out.update(step_keys=keys, trajectory=trajectory)
    out["n_anchors"] = sum(a.shape[0] for a in out["anchors"])
    out["n_pool"] = JAX_TINY.post_nms_top_n_train + K
    return out


def port_detector(ref):
    return faster_rcnn_from_jax(ref["variables"], FASTER_RCNN_TINY,
                                device="cpu")


def flat_levels(ref):
    """The reference's per-level (B, h, w, A) logits and (B, h, w, 4A)
    deltas as the port's (B, h*w*A) and (B, h*w*A, 4)."""
    lg = [T(x.reshape(B, -1)) for x in ref["logits"]]
    dl = [T(x.reshape(B, -1, 4)) for x in ref["deltas"]]
    return lg, dl


def test_sample_balanced_matches_jax():
    """Rank-mask sampling with the reference's draws injected: the same
    positive and negative masks, at the RPN's and the RoI head's
    budgets."""
    rng = np.random.RandomState(3)
    labels = rng.choice([-1, 0, 0, 0, 1], size=(B, 900)).astype(np.int32)
    labels[1, :700] = -1                     # few candidates: all taken
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    for size, frac in ((256, 0.5), (32, 0.25)):
        ref = [jfr.sample_balanced(jnp.asarray(labels[b]), keys[b], size,
                                   frac) for b in range(B)]
        d = [jax_draws(keys[b], labels.shape[1]) for b in range(B)]
        u = tuple(T(np.stack([x[j] for x in d])) for j in range(2))
        pos, neg = pfr.sample_balanced(T(labels), size, frac, uniforms=u)
        for b in range(B):
            np.testing.assert_array_equal(pos[b].numpy(), ref[b][0])
            np.testing.assert_array_equal(neg[b].numpy(), ref[b][1])
        assert int(pos[0].sum()) == int(size * frac)


def test_match_to_gt_matches_jax(ref):
    """IoU matching with padded GT rows and the best-anchor rule: the same
    labels and matched indices."""
    anchors = np.concatenate(ref["anchors"])
    batch = ref["batch"]
    labels, matched = pfr.match_to_gt(T(anchors), T(batch["boxes"]),
                                      T(batch["box_mask"]), 0.7, 0.3)
    for b in range(B):
        rl, rm = jfr.match_to_gt(jnp.asarray(anchors),
                                 jnp.asarray(batch["boxes"][b]),
                                 jnp.asarray(batch["box_mask"][b]), 0.7, 0.3)
        np.testing.assert_array_equal(labels[b].numpy(), rl)
        np.testing.assert_array_equal(matched[b].numpy(), rm)
    assert set(labels.unique().tolist()) == {-1, 0, 1}


def test_select_proposals_train_matches_jax(ref):
    """Train-budget proposals from the reference's own train-mode RPN
    outputs: scores exact, boxes within 1e-4 px (the exp of box decoding,
    1e-6 relative)."""
    lg, dl = flat_levels(ref)
    anchors = [T(a) for a in ref["anchors"]]
    boxes, scores = pfr.select_proposals(FASTER_RCNN_TINY, anchors, lg, dl,
                                         train=True)
    assert boxes.shape == (B, JAX_TINY.post_nms_top_n_train, 4)
    for b in range(B):
        rb, rs = jfr.select_proposals(
            JAX_TINY, [jnp.asarray(a) for a in ref["anchors"]],
            [jnp.asarray(x[b]) for x in ref["logits"]],
            [jnp.asarray(x[b]) for x in ref["deltas"]], True)
        np.testing.assert_array_equal(scores[b].numpy(), rs)
        np.testing.assert_allclose(boxes[b].numpy(), rb, rtol=0, atol=1e-4)


def test_rpn_loss_and_roi_targets_match_jax(ref):
    """rpn_loss (1e-5 relative) and roi_targets (boxes, labels, masks
    exact; regression targets 1e-5 relative) per image with the
    reference's draws, on the reference's RPN outputs and proposals."""
    batch = ref["batch"]
    lg, dl = flat_levels(ref)
    anchors = np.concatenate(ref["anchors"])
    u = port_uniforms(ref["key"], ref["n_anchors"], ref["n_pool"])
    obj, reg = pfr.rpn_loss(FASTER_RCNN_TINY, T(anchors), torch.cat(lg, 1),
                            torch.cat(dl, 1), T(batch["boxes"]),
                            T(batch["box_mask"]), u["rpn"])
    props, _ = pfr.select_proposals(FASTER_RCNN_TINY,
                                    [T(a) for a in ref["anchors"]], lg, dl,
                                    train=True)
    got = pfr.roi_targets(FASTER_RCNN_TINY, props, T(batch["boxes"]),
                          T(batch["labels"]), T(batch["box_mask"]), u["roi"])
    rngs = jax.random.split(ref["key"], B * 2).reshape(B, 2, -1)
    lg_flat, dl_flat = torch.cat(lg, 1).numpy(), torch.cat(dl, 1).numpy()
    for b in range(B):
        r_obj, r_reg = jfr.rpn_loss(
            JAX_TINY, jnp.asarray(anchors),
            jnp.asarray(lg_flat[b]), jnp.asarray(dl_flat[b]),
            jnp.asarray(batch["boxes"][b]), jnp.asarray(batch["box_mask"][b]),
            rngs[b, 0])
        np.testing.assert_allclose(float(obj[b]), float(r_obj), rtol=1e-5)
        np.testing.assert_allclose(float(reg[b]), float(r_reg), rtol=1e-5)
        want = jfr.roi_targets(JAX_TINY, jnp.asarray(props[b].numpy()),
                               jnp.asarray(batch["boxes"][b]),
                               jnp.asarray(batch["labels"][b]),
                               jnp.asarray(batch["box_mask"][b]), rngs[b, 1])
        for name, g, w in zip(("boxes", "labels", "reg_targets", "pos",
                               "sampled"), got, want):
            g, w = g[b].numpy(), np.asarray(w)
            if name == "reg_targets":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
        assert 0 < int(got[3][b].sum()) < int(got[4][b].sum())


def test_roi_loss_matches_jax():
    rng = np.random.RandomState(4)
    R, nc = 32, 2
    cls = rng.randn(B, R, nc).astype(np.float32)
    deltas = rng.randn(B, R, 4 * nc).astype(np.float32)
    labels = rng.randint(0, nc, (B, R)).astype(np.int32)
    targets = rng.randn(B, R, 4).astype(np.float32)
    sampled = rng.rand(B, R) > 0.2
    pos = sampled & (labels == 1)
    lc, lb = pfr.roi_loss(FASTER_RCNN_TINY, T(cls), T(deltas), T(labels),
                          T(targets), T(pos), T(sampled))
    for b in range(B):
        rc, rb = jfr.roi_loss(JAX_TINY, cls[b], deltas[b], labels[b],
                              targets[b], pos[b], sampled[b])
        np.testing.assert_allclose(float(lc[b]), float(rc), rtol=1e-5)
        np.testing.assert_allclose(float(lb[b]), float(rb), rtol=1e-5)


def test_loss_fn_terms_and_gradients_match_jax(ref):
    """FasterRCNN.loss_fn in train mode with the reference's draws: the
    four terms within 1e-5 relative, every parameter's gradient within
    1e-4 of its max abs (f32 convolutions and train-mode BatchNorm summed
    in another order)."""
    port = port_detector(ref)
    u = port_uniforms(ref["key"], ref["n_anchors"], ref["n_pool"])
    total, terms = port.loss_fn(torch_batch(ref["batch"]), uniforms=u)
    assert port.training
    total.backward()
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
        assert v > 0, k
    np.testing.assert_allclose(float(total.detach()), ref["total"],
                               rtol=1e-5)
    want = jax_variables_to_state_dict({"params": ref["grads"]})
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _stats_after_one_step(ref, port):
    u = port_uniforms(ref["key"], ref["n_anchors"], ref["n_pool"])
    with torch.no_grad():
        port.loss_fn(torch_batch(ref["batch"]), uniforms=u)
    return port.state_dict()


def test_batch_stats_after_one_step_match_jax(ref):
    """The running statistics after one train-mode forward, every
    BatchNorm, stem_bn included: every statistic (O(0.1-1.5) here) within
    1e-6, and the stem's running variance within 1e-6 relative. With the
    stem built as nn.BatchNorm2d (which moves the running variance toward
    the unbiased batch variance, n / (n - 1) larger, n = 2 x 64 x 64
    here), the stem's running variance read 2.2e-6 relative from the
    reference: checked below, so the test pins the flax update."""
    want = jax_variables_to_state_dict({"params": {},
                                        "batch_stats": ref["stats"]})
    got = _stats_after_one_step(ref, port_detector(ref))
    assert len(want) == 2 * sum(1 for k in got if k.endswith("running_var"))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    stem = "backbone.stem_bn.running_var"
    np.testing.assert_allclose(got[stem].numpy(), want[stem].numpy(),
                               rtol=1e-6, atol=0)

    port = port_detector(ref)
    torch_bn = torch.nn.BatchNorm2d(port.backbone.stem_bn.num_features)
    torch_bn.load_state_dict(port.backbone.stem_bn.state_dict())
    port.backbone.stem_bn = torch_bn
    old = _stats_after_one_step(ref, port)[stem].numpy()
    rel = np.abs(old - want[stem].numpy()) / want[stem].numpy()
    assert rel.max() > 1e-6


def test_nonfinite_guard_matches_jax(ref):
    """make_detector_train_step with Adam (lr 1e-5) and the perceptual
    weighting: a finite step, a step whose weighting makes the loss
    infinite, a finite step. The bad step leaves every parameter as it
    was (exactly) while Adam's moments decay and its count advances, in
    both programs. The finite steps' losses (1e-5 relative) and Adam's
    moments after the third (1e-4 of each tensor's max abs) equal the
    reference's. So do the parameters, within 1e-2 lr and 2 ulps, wherever
    Adam's first moment is above 1e-2 of its tensor's max abs, so that the
    1e-4-of-max agreement of the gradients is 1e-2 of the element's own.
    Elsewhere Adam's update, lr m / (sqrt(v) + eps), is a ratio of two
    small, rounded numbers, sign-like on the first steps: a gradient that
    rounding flips moves its element by up to 2 lr (6 to 64 of the
    2.86 M elements by more than 1e-2 lr in different runs: the CPU's
    scatter-adds sum in varying order)."""
    port = port_detector(ref)
    state = create_train_state(port, EXP)
    step = make_detector_train_step(perceptual_cfg=EXP)
    batch = torch_batch(ref["batch"])
    bad = dict(batch, perceptual_loss=torch.full((B,), float("inf")))
    params, moments, metrics = [], [], []
    for b, k in zip((batch, bad, batch), ref["step_keys"]):
        u = port_uniforms(k, ref["n_anchors"], ref["n_pool"])
        metrics.append({m: float(v) for m, v in step(state, b,
                                                     uniforms=u).items()})
        params.append(copy.deepcopy({n: p.detach() for n, p in
                                     port.named_parameters()}))
        moments.append({n: state.optimizer.state[p]["exp_avg"].clone()
                        for n, p in port.named_parameters()})
    assert [m["finite"] for m in metrics] == [1.0, 0.0, 1.0]
    assert np.isinf(metrics[1]["loss"])
    for n in params[0]:
        assert torch.equal(params[1][n], params[0][n]), n
        np.testing.assert_allclose(moments[1][n].numpy(),
                                   0.9 * moments[0][n].numpy(), rtol=1e-6,
                                   atol=0, err_msg=n)
    assert all(float(s["step"]) == 3.0
               for s in state.optimizer.state.values())
    assert state.step == 3

    for i in (0, 2):
        np.testing.assert_allclose(metrics[i]["loss"],
                                   ref["trajectory"][i][1]["loss"],
                                   rtol=1e-5)
    jstate = ref["trajectory"][2][0]
    adam = jstate.opt_state.inner_state[0]
    assert int(adam.count) == 3
    ref_p = [jax.tree_util.tree_leaves(t[0].params)
             for t in ref["trajectory"][:2]]
    assert all(np.array_equal(a, b) for a, b in zip(*ref_p))
    lr = EXP["training"]["learning_rate"]
    want = jax_variables_to_state_dict({"params": jstate.params})
    mu = jax_variables_to_state_dict({"params": adam.mu})
    nu = jax_variables_to_state_dict({"params": adam.nu})
    for n, p in port.named_parameters():
        for key, ref_m in (("exp_avg", mu), ("exp_avg_sq", nu)):
            w = ref_m[n].numpy()
            np.testing.assert_allclose(
                state.optimizer.state[p][key].numpy(), w, rtol=0,
                atol=1e-4 * np.abs(w).max(), err_msg=f"{n} {key}")
        got = params[2][n].numpy()
        # beyond the update's error, the sum p + u rounds to an ulp of p
        err = np.abs(got - want[n].numpy()) - 2 * np.spacing(np.abs(got))
        m = np.abs(mu[n].numpy())
        assert err.max() <= 2.001 * lr, n
        assert err[m > 1e-2 * m.max()].max() <= 1e-2 * lr, n


def test_predict_after_a_train_step_uses_eval_batchnorm(ref):
    """predict right after a train-mode step runs eval BatchNorm on the
    updated running statistics: it leaves them as they are, and its
    detections equal those of a copy of the detector put in eval mode
    before the call."""
    port = port_detector(ref)
    step = make_detector_train_step()
    step(create_train_state(port, EXP), torch_batch(ref["batch"]),
         generator=torch.Generator().manual_seed(0))
    assert port.training
    fresh = copy.deepcopy(port).eval()
    stats = {k: v.clone() for k, v in port.state_dict().items()}
    images = T(ref["batch"]["image"])
    got = port.predict(images)
    assert not port.training
    for k, v in port.state_dict().items():      # no batch statistics taken
        assert torch.equal(v, stats[k]), k
    want = fresh.predict(images)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_loss_fn_refuses_the_folded_trunk():
    """Training needs the live-BatchNorm trunk, as the reference's
    loss_fn says."""
    det = pfr.FasterRCNN(FASTER_RCNN_TINY, device="cpu",
                         trunk_quant="folded")
    with pytest.raises(ValueError, match="live-BN trunk"):
        det.loss_fn(torch_batch(make_batch()))
