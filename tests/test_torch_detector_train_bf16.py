"""bf16 detector training of the Faster R-CNN family: the port
(stlpose_tpu_torch/models/faster_rcnn.py with ``dtype=torch.bfloat16,
param_dtype=torch.float32``, kernels/roi_align.py's bf16 RoIAlign and its
gradient, parallel/detector_steps.py, engines/detector_trainer.py and
02_train_faster_rcnn.py) against the JAX package's bf16
FasterRCNN.loss_fn on FASTER_RCNN_TINY, the same f32 weights
(models/convert.py) and the same sampling draws (rebuilt from the JAX keys
as tests/test_torch_detector_train.py does).

Held stage by stage, since two bf16 programs that round at other points
select other proposals from near-tied bf16 RPN logits (ROADMAP.md, Queue
3): the RPN loss on the reference's own bf16 logits and deltas; the RoI
sampling, the box head, the loss terms, the gradients and the BatchNorm
statistics with the proposals pinned to the reference's own
(``loss_fn(proposals=...)``; the reference runs its loss_fn's own stages
on those proposals, ``staged_loss`` below).

bf16 bounds follow tests/test_bf16_accuracy.py: the port's bf16 result is
held against the reference's f32 result on the same inputs, no further
from it than a factor times the reference's own bf16 result.

- RoIAlign and its gradient (K3 bf16_bf16 and K3b bf16 by their plain
  versions): factor 1. The port sums in f32 and rounds once; the
  reference's banded RoIAlign rounds its sample fractions, its 2-tap
  interpolation and its weights to bf16, and its VJP adds into bf16 maps.
- The network (NET_FACTOR, 2): both programs round each bf16 operation's
  result, at the same points, with their own accumulation orders inside
  the convolutions and products, so their drifts from f32 are of one size
  but not the same draws; twice the reference's would mean that the port
  rounds more often or worse. The drifts are compared as maxima (and
  medians) over many values, not value by value: one scalar's drift can
  be near 0 by chance in either program. Readings on these inputs (port /
  reference): the loss terms' largest relative drift 7.46e-3 / 7.44e-3;
  the gradients' drift of a tensor's max abs, largest 0.70 / 0.63 (the
  BatchNorm scales of the first stages, sums of terms that cancel),
  median 0.31 / 0.32; the running statistics' largest 4.96e-3 /
  4.84e-3.

The reference is compiled with XLA's ``xla_allow_excess_precision`` off.
XLA's CPU compiler by default drops the bf16 rounding between fused
operations (a bf16 convolution's output reaches its f32 BatchNorm
unrounded), which neither the reference run op by op nor a bf16 program
on the card does: jitted so, its RPN logits read 4.9e-2 of their max abs
from f32 and its objectness term 6.9e-6 from f32, against 7.9e-2 and
1.2e-3 run op by op (82 s) and 8.4e-2 and 1.5e-3 compiled strict (6 s).

The reference's train-mode BatchNorm takes its statistics with flax's
two-pass variance here, as in the f32 tests, for the same reason (its one
pass, E[x^2] - E[x]^2, cancels). Under bf16 compute the statistics are
still taken in f32 (every BatchNorm of the reference is ``dtype=float32``
and widens the bf16 convolution output, as the port's ``FlaxBatchNorm2d``
does), so the reasoning is unchanged.
"""

import importlib

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import faster_rcnn as jfr
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu.models.faster_rcnn import FasterRCNNModule
from stlpose_tpu.ops.roi_align import multilevel_roi_align
from stlpose_tpu_torch.config import FASTER_RCNN_TINY
from stlpose_tpu_torch.engines.detector_trainer import (DetectorEvaluator,
                                                        DetectorTrainer)
from stlpose_tpu_torch.kernels import roi_align as _k3
from stlpose_tpu_torch.models import faster_rcnn as pfr
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.parallel.detector_steps import \
    make_detector_train_step
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                list_checkpoints)
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.fixtures import make_coco_dataset
from tests.test_torch_detector_train import (B, EXP, make_batch,
                                             port_uniforms, torch_batch,
                                             two_pass_stats)
from tests.test_torch_hrnet import random_variables
from tests.test_torch_roi_align_backward import (STRIDES, jax_map_grads,
                                                 planted_scene)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

NET_FACTOR = 2.0
BF16 = torch.bfloat16
T = torch.from_numpy
TERMS = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
         "loss_box_reg")


def staged_loss(det):
    """The reference's FasterRCNN.loss_fn, its own stages in its own order
    (train-mode apply, per-image rpn_loss, select_proposals, roi_targets,
    the RoI head, roi_loss, means and their sum), with the RoI stage on
    proposals handed in; its own proposals come back beside. With its
    gradient, to be compiled by ``compiled``."""
    cfg = det.config

    def loss(params, stats, batch, props, key):
        variables = {"params": params, "batch_stats": stats}
        (feats, logits, deltas), upd = det.module.apply(
            variables, batch["image"], train=True, mutable=["batch_stats"])
        anchors_l = det._get_anchors(logits)
        anchors = jnp.concatenate(anchors_l)
        rngs = jax.random.split(key, B * 2).reshape(B, 2, -1)

        def per_image(lg, dl, feats_i, gtb, gtl, gtm, props_i, rng2):
            lg_flat = jnp.concatenate([x.reshape(-1) for x in lg])
            dl_flat = jnp.concatenate([x.reshape(-1, 4) for x in dl])
            l_obj, l_rpn = jfr.rpn_loss(cfg, anchors, lg_flat, dl_flat, gtb,
                                        gtm, rng2[0])
            own, _ = jfr.select_proposals(cfg, anchors_l, list(lg), list(dl),
                                          True)
            boxes, labels, regs, pos, sampled = jfr.roi_targets(
                cfg, props_i, gtb, gtl, gtm, rng2[1])
            cls, box = det.module.apply(variables, list(feats_i), boxes,
                                        method=FasterRCNNModule.roi)
            l_cls, l_box = jfr.roi_loss(cfg, cls, box, labels, regs, pos,
                                        sampled)
            return (l_obj, l_rpn, l_cls, l_box), jax.lax.stop_gradient(own)

        terms, own = jax.vmap(per_image)(
            tuple(logits), tuple(deltas), tuple(feats[:4]), batch["boxes"],
            batch["labels"], batch["box_mask"], props, rngs)
        terms = dict(zip(TERMS, (t.mean() for t in terms)))
        total = (terms["loss_objectness"] + terms["loss_rpn_box_reg"] +
                 terms["loss_classifier"] + terms["loss_box_reg"])
        return total, (terms, upd["batch_stats"], own, logits, deltas)

    return jax.value_and_grad(loss, has_aux=True)


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's excess precision
    off, so that each bf16 operation rounds its result as the source
    reads (see the module's docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def run_staged(fn, variables, batch, props, key):
    args = (variables["params"], variables["batch_stats"], batch, props, key)
    (total, (terms, stats, own, logits, deltas)), grads = \
        compiled(fn, *args)(*args)
    return {"total": np.asarray(total), "terms": jax.device_get(terms),
            "stats": jax.device_get(stats), "own": np.array(own),
            "logits": [np.asarray(x) for x in logits],
            "deltas": [np.asarray(x) for x in deltas],
            "grads": jax.device_get(grads)}


@pytest.fixture(scope="module")
def ref():
    """The staged reference in bf16 and in f32, both on the bf16
    reference's own proposals, under the two-pass statistics."""
    det_b = JaxFasterRCNN(JAX_TINY, dtype=jnp.bfloat16, pallas_roi=False)
    det_f = JaxFasterRCNN(JAX_TINY, pallas_roi=False)
    abstract = jax.eval_shape(lambda: det_f.init(jax.random.PRNGKey(0)))
    variables = random_variables(abstract, 0)
    batch = make_batch()
    jbatch = {k: v for k, v in batch.items() if k != "perceptual_loss"}
    key = jax.random.PRNGKey(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass_stats)
        fn_b = staged_loss(det_b)
        own = run_staged(fn_b, variables, jbatch, np.zeros(
            (B, JAX_TINY.post_nms_top_n_train, 4), np.float32), key)["own"]
        out = {"bf16": run_staged(fn_b, variables, jbatch, own, key),
               "f32": run_staged(staged_loss(det_f), variables, jbatch, own,
                                 key)}
    anchors = det_f._get_anchors(out["f32"]["logits"])
    out.update(variables=variables, batch=batch, key=key, props=own,
               anchors=[np.asarray(a) for a in anchors],
               n_anchors=sum(a.shape[0] for a in anchors),
               n_pool=JAX_TINY.post_nms_top_n_train + batch["boxes"].shape[1])
    return out


def port_detector(ref):
    return faster_rcnn_from_jax(ref["variables"], FASTER_RCNN_TINY,
                                device="cpu", dtype=BF16,
                                param_dtype=torch.float32)


@pytest.fixture(scope="module")
def port_step(ref):
    """The port's bf16 loss_fn and backward on the pinned proposals."""
    port = port_detector(ref)
    u = port_uniforms(ref["key"], ref["n_anchors"], ref["n_pool"])
    total, terms = port.loss_fn(torch_batch(ref["batch"]), uniforms=u,
                                proposals=T(ref["props"]))
    total.backward()
    return port, total, terms


def rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_roi_align_bf16_and_gradient_match_jax():
    """K3 bf16_bf16's and K3b bf16's plain versions (the path's CPU
    versions) on tests/test_torch_roi_align_backward.py's planted scene,
    against the reference's banded multilevel_roi_align in bf16 and its
    VJP: the forward and every level's gradient in bf16, each no further
    from the reference's f32 result (in its max abs) than the reference's
    own bf16 result. Both round once: every element within half a bf16
    step (2^-8 relative) of the f32 result, plus 1e-5 of the max abs for
    the f32 sums' order."""
    feats, boxes, levels = planted_scene()
    C = feats[0].shape[-1]
    grad = np.random.RandomState(1).randn(*boxes.shape[:2], 7, 7, C)
    grad = T(grad.astype(np.float32)).to(BF16)
    g32 = grad.float().numpy()
    fb = [T(f).to(BF16) for f in feats]
    f32 = [f.float().numpy() for f in fb]          # the bf16 maps, widened

    def ref_fwd(fs, dtype):
        return np.stack([np.asarray(multilevel_roi_align(
            [jnp.asarray(f[b], dtype) for f in fs], jnp.asarray(boxes[b]),
            strides=STRIDES), np.float32) for b in range(boxes.shape[0])])

    fwd = _k3.roi_align_plain(fb, T(boxes), levels, STRIDES,
                              out_dtype=BF16)
    assert fwd.dtype == BF16
    want, ref_b = ref_fwd(f32, jnp.float32), ref_fwd(f32, jnp.bfloat16)
    got = fwd.float().numpy()
    assert rel(got, want) <= rel(ref_b, want)
    assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want) +
            1e-5 * np.abs(want).max()).all()

    maps = _k3.roi_align_backward_plain(grad, [f.shape for f in feats],
                                        T(boxes), levels, STRIDES)
    want = jax_map_grads(multilevel_roi_align, f32, boxes, g32)
    ref_b = jax_map_grads(
        multilevel_roi_align, [f.astype(jnp.bfloat16) for f in f32], boxes,
        np.asarray(jnp.asarray(g32, jnp.bfloat16)))
    for li, (m, w, r) in enumerate(zip(maps, want, ref_b)):
        assert m.dtype == BF16 and r.dtype == jnp.bfloat16
        g = m.float().numpy()
        assert rel(g, w) <= rel(r.astype(np.float32), w), li
        assert (np.abs(g - w) <= 2.0 ** -8 * np.abs(w) +
                1e-5 * np.abs(w).max()).all(), li




def test_rpn_loss_on_the_reference_bf16_outputs(ref):
    """rpn_loss on the reference's own bf16 train-mode logits and deltas,
    with its draws: both terms f32 (the f32 targets promote the bf16
    logits), within 1e-5 relative of the reference's, per image: the same
    bf16 operations on the same bf16 inputs, the f32 sums in another
    order."""
    r = ref["bf16"]
    lg = torch.cat([T(np.asarray(x, np.float32).reshape(B, -1))
                    for x in r["logits"]], 1).to(BF16)
    dl = torch.cat([T(np.asarray(x, np.float32).reshape(B, -1, 4))
                    for x in r["deltas"]], 1).to(BF16)
    batch = ref["batch"]
    u = port_uniforms(ref["key"], ref["n_anchors"], ref["n_pool"])
    anchors = np.concatenate(ref["anchors"])
    obj, reg = pfr.rpn_loss(FASTER_RCNN_TINY, T(anchors), lg, dl,
                            T(batch["boxes"]), T(batch["box_mask"]),
                            u["rpn"])
    assert obj.dtype == reg.dtype == torch.float32
    rngs = jax.random.split(ref["key"], B * 2).reshape(B, 2, -1)
    for b in range(B):
        r_obj, r_reg = jfr.rpn_loss(
            JAX_TINY, jnp.asarray(anchors),
            jnp.asarray(lg[b].float().numpy(), jnp.bfloat16),
            jnp.asarray(dl[b].float().numpy(), jnp.bfloat16),
            jnp.asarray(batch["boxes"][b]), jnp.asarray(batch["box_mask"][b]),
            rngs[b, 0])
        assert r_obj.dtype == r_reg.dtype == jnp.float32
        np.testing.assert_allclose(float(obj[b]), float(r_obj), rtol=1e-5)
        np.testing.assert_allclose(float(reg[b]), float(r_reg), rtol=1e-5)


def test_roi_sampling_on_pinned_proposals_matches_jax(ref):
    """roi_targets on the reference's own bf16 proposals with its draws:
    boxes, labels and masks exact, regression targets 1e-5 relative, per
    image; the sample holds positives and negatives."""
    batch = ref["batch"]
    u = port_uniforms(ref["key"], ref["n_anchors"], ref["n_pool"])
    got = pfr.roi_targets(FASTER_RCNN_TINY, T(ref["props"]),
                          T(batch["boxes"]), T(batch["labels"]),
                          T(batch["box_mask"]), u["roi"])
    rngs = jax.random.split(ref["key"], B * 2).reshape(B, 2, -1)
    for b in range(B):
        want = jfr.roi_targets(JAX_TINY, jnp.asarray(ref["props"][b]),
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


def test_loss_terms_and_dtypes_on_pinned_proposals(ref, port_step):
    """loss_fn in bf16 on f32 weights, on the pinned proposals: each term
    in the reference's dtype (loss_classifier bf16, the other three and
    the total f32), every term finite and positive, and the terms' largest
    relative drift from the reference's f32 terms within NET_FACTOR of the
    reference's bf16 terms' (readings in the module's docstring)."""
    _, total, terms = port_step
    rb, rf = ref["bf16"], ref["f32"]
    assert total.dtype == torch.float32 and rb["total"].dtype == np.float32
    drift = {"port": [], "ref": []}
    for k in TERMS:
        bf16 = k == "loss_classifier"
        assert terms[k].dtype == (BF16 if bf16 else torch.float32), k
        assert rb["terms"][k].dtype == (jnp.bfloat16 if bf16
                                        else jnp.float32), k
        f = float(rf["terms"][k])
        got = float(terms[k].detach().float())
        assert np.isfinite(got) and got > 0, k
        drift["port"].append(abs(got - f) / f)
        drift["ref"].append(abs(float(rb["terms"][k]) - f) / f)
    assert max(drift["port"]) <= NET_FACTOR * max(drift["ref"]), drift
    f = float(rf["total"])
    assert abs(float(total.detach()) - f) / f <= \
        NET_FACTOR * abs(float(rb["total"]) - f) / f + max(drift["ref"])


def test_gradients_on_pinned_proposals(ref, port_step):
    """Every f32 master weight gets an f32 gradient. Each tensor's drift
    from the reference's f32 gradient (of its max abs): the largest and
    the median over the tensors within NET_FACTOR of the reference's bf16
    gradient's (readings in the module's docstring)."""
    port = port_step[0]
    wb = jax_variables_to_state_dict({"params": ref["bf16"]["grads"]})
    wf = jax_variables_to_state_dict({"params": ref["f32"]["grads"]})
    named = dict(port.named_parameters())
    assert set(named) == set(wf) == set(wb)
    drift = {"port": [], "ref": []}
    for name, p in named.items():
        assert p.dtype == p.grad.dtype == torch.float32, name
        f = wf[name].numpy()
        assert np.abs(f).max() > 0, name
        drift["port"].append(rel(p.grad.numpy(), f))
        drift["ref"].append(rel(wb[name].float().numpy(), f))
    for stat in (np.max, np.median):
        assert stat(drift["port"]) <= NET_FACTOR * stat(drift["ref"]), \
            (stat.__name__, stat(drift["port"]), stat(drift["ref"]))


def test_batch_stats_after_one_bf16_step(ref, port_step):
    """The running statistics after the bf16 train-mode forward, every
    BatchNorm's: f32, and their largest drift from the reference's f32
    statistics (of each tensor's max abs) within NET_FACTOR of the
    reference's bf16 statistics'."""
    port = port_step[0]
    wb = jax_variables_to_state_dict({"params": {},
                                      "batch_stats": ref["bf16"]["stats"]})
    wf = jax_variables_to_state_dict({"params": {},
                                      "batch_stats": ref["f32"]["stats"]})
    got = port.state_dict()
    drift = {"port": [], "ref": []}
    for k, f in wf.items():
        assert got[k].dtype == wb[k].dtype == torch.float32, k
        drift["port"].append(rel(got[k].numpy(), f.numpy()))
        drift["ref"].append(rel(wb[k].numpy(), f.numpy()))
    assert max(drift["port"]) <= NET_FACTOR * max(drift["ref"]), drift


def test_train_step_keeps_f32_masters_and_moves_them(ref):
    """make_detector_train_step on the bf16 detector with Adam, proposals
    selected from its own bf16 logits (K5's plain version on the CPU): a
    finite f32 loss, every master still f32 and moved (each gets a
    gradient), Adam's moments f32; then a step whose perceptual weighting
    makes the loss infinite leaves every master as it was."""
    port = port_detector(ref)
    state = create_train_state(port, EXP)
    step = make_detector_train_step(perceptual_cfg=EXP)
    batch = torch_batch(ref["batch"])
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    m = step(state, batch, generator=torch.Generator().manual_seed(0))
    assert m["loss"].dtype == torch.float32 and float(m["finite"]) == 1.0
    assert m["loss_classifier"].dtype == BF16
    for n, p in port.named_parameters():
        assert p.dtype == torch.float32, n
        assert not torch.equal(p, before[n]), n
        for v in state.optimizer.state[p].values():
            assert v.dtype == torch.float32, n
    after = {n: p.detach().clone() for n, p in port.named_parameters()}
    bad = dict(batch, perceptual_loss=torch.full((B,), float("inf")))
    m = step(state, bad, generator=torch.Generator().manual_seed(1))
    assert float(m["finite"]) == 0.0
    for n, p in port.named_parameters():
        assert torch.equal(p, after[n]), n


def test_predict_on_the_masters_equals_the_bf16_serving_detector(ref):
    """Validation predicts with the trained detector, bf16 compute on f32
    masters: the same detections, bit for bit, as the bf16 serving
    detector (weights stored rounded to bf16) built from those masters."""
    trained = port_detector(ref)
    serving = faster_rcnn_from_jax(ref["variables"], FASTER_RCNN_TINY,
                                   device="cpu", dtype=BF16)
    assert {p.dtype for p in serving.parameters()
            if p.dim() > 1} == {BF16}
    images = T(ref["batch"]["image"])
    got, want = trained.predict(images), serving.predict(images)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


TINY = "faster_rcnn_tiny"
OVERRIDES = {"batch_size": 2, "num_epochs": 1, "save_frequency": 1,
             "learning_rate": 1e-3}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_data_bf16")
    make_coco_dataset(str(root), n_train=4, n_val=2, img_hw=(128, 160))
    return str(root)


def checkpoint_tensors(exp_path, epoch):
    blob = torch.load(checkpoint_path(exp_path, epoch, detector=True) +
                      ".pt", map_location="cpu", weights_only=True)
    return blob["model_state_dict"]


def test_bf16_trainer_writes_f32_checkpoints_that_serve_in_bf16(
        tmp_path, data):
    """DetectorTrainer(dtype=bfloat16): the detector it trains computes in
    bf16 on f32 masters, its epoch gives a finite loss and an AP, its
    checkpoints hold f32 weights only, a resume restores them, and
    DetectorEvaluator in bf16 loads the final one into its bf16 serving
    detector (each weight the checkpoint's, rounded to bf16) and scores
    12 stats."""
    exp_path = create_experiment("det_bf16", OVERRIDES, root=str(tmp_path))
    tr = DetectorTrainer(exp_path, data_path=data, num_workers=2,
                         detector_config=TINY, device="cpu", dtype=BF16)
    tr.load_dataset()
    tr.setup_model()
    assert tr.detector.dtype == BF16
    assert {p.dtype for p in tr.detector.parameters()} == {torch.float32}
    tr.training_loop()
    assert set(list_checkpoints(exp_path, detector=True)) == {"0", "final"}
    final = checkpoint_tensors(exp_path, "final")
    assert {v.dtype for k, v in final.items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
    for k, v in tr.detector.state_dict().items():
        assert torch.equal(v, final[k]), k

    resumed = DetectorTrainer(exp_path, checkpoint="0", resume_training=True,
                              data_path=data, num_workers=2,
                              detector_config=TINY, device="cpu", dtype=BF16)
    resumed.load_dataset()
    resumed.setup_model()
    want = checkpoint_tensors(exp_path, "0")
    for k, v in resumed.detector.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    assert resumed.state.step == 2

    ev = DetectorEvaluator(exp_path, checkpoint="final", data_path=data,
                           num_workers=2, detector_config=TINY, dtype=BF16,
                           device="cpu")
    ev.setup()
    for k, v in ev.detector.state_dict().items():
        assert torch.equal(v, final[k].to(v.dtype)), k
    assert ev.detector.fpn.out0.weight.dtype == BF16
    stats = ev.evaluate()
    assert len(stats) == 12 and all(s == -1.0 or 0.0 <= s <= 1.0
                                    for s in stats)


def test_02_trains_in_bf16_under_stlpose_dtype(tmp_path, data, monkeypatch):
    """02_train_faster_rcnn.py's main under STLPOSE_DTYPE=bfloat16 trains
    the bf16 detector on f32 masters and writes f32 checkpoints; 03 under
    the same variable evaluates the final one in bf16."""
    monkeypatch.setenv("STLPOSE_DTYPE", "bfloat16")
    monkeypatch.setenv("STLPOSE_DETECTOR_CONFIG", TINY)
    monkeypatch.setenv("STLPOSE_DETECTOR_PRETRAINED", "")
    exp_path = create_experiment("det_cli_bf16", OVERRIDES,
                                 root=str(tmp_path))
    train = importlib.import_module(
        "stlpose_tpu_torch.scripts.02_train_faster_rcnn")
    tr = train.main(["-d", exp_path, "--data_path", data, "--device",
                     "cpu"])
    assert tr.dtype == tr.detector.dtype == BF16
    assert {p.dtype for p in tr.detector.parameters()} == {torch.float32}
    assert {v.dtype for k, v in checkpoint_tensors(exp_path, "final").items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
    evaluate = importlib.import_module(
        "stlpose_tpu_torch.scripts.03_evaluate_faster_rcnn")
    stats = evaluate.main(["-d", exp_path, "--checkpoint", "final",
                           "--data_path", data, "--device", "cpu"])
    assert len(stats) == 12 and all(np.isfinite(stats))
