"""EfficientDet: the PyTorch port (stlpose_tpu_torch/models/efficientnet.py
and efficientdet.py) against the JAX package's on the same numpy weights
(carried across by models/convert.py::efficientdet_from_jax) and inputs.

The JAX variables come from ``jax.eval_shape`` of Flax's init, filled with
seeded numpy values (Flax's own init of the tiny detector takes ~17 s
jitted). The BatchNorm statistics are then calibrated on the test images
(one train-mode forward of the port with momentum 1, read back as the
running statistics), so that the eval-mode network keeps the images'
signal: with uncalibrated random statistics the deep trunk forgets its
input, and the class scores of one level tie to 1e-7 across positions.
Each JAX function is jitted once per module fixture.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import efficientdet as jed
from stlpose_tpu.models import efficientnet as jen
from stlpose_tpu_torch import config as pcfg
from stlpose_tpu_torch.models import efficientdet as ped
from stlpose_tpu_torch.models import efficientnet as pen
from stlpose_tpu_torch.models.convert import efficientdet_from_jax
from tests.test_torch_hrnet import random_variables
import tests.torch_threads  # noqa: F401  (caps torch's threads)

S = 128
# D0's widths (the b0 trunk at width and depth 1, 64 BiFPN channels) at
# the depth of tests/test_efficientdet_convert.py's TINY2
D0_WIDTHS = dict(image_size=S, fpn_channels=64, fpn_repeats=2,
                 head_repeats=1, pre_nms_top_n=64, detections_per_img=8)
# a score closer than this to another, or to score_thresh, could trade
# places between two f32 programs (they differ by ~1e-7 here)
TIE_GAP = 1e-4


@functools.lru_cache(maxsize=None)
def abstract_variables(cfg):
    """The JAX EfficientDet of ``cfg`` and its variables' shapes (Flax's
    init traced, not run)."""
    det = jed.EfficientDet(cfg)
    return det, jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0)))


def jax_variables(cfg, seed):
    """Seeded numpy variables for the JAX EfficientDet of ``cfg``, fusion
    weights uniform in [0.5, 1.5] (a negative one would switch its input
    off through the ReLU)."""
    det, abstract = abstract_variables(cfg)
    v = jax.tree_util.tree_map(np.asarray, random_variables(abstract, seed))
    v = {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}
    rng = np.random.RandomState(seed + 100)
    for name, sub in v["params"].items():
        if name.startswith("bifpn_"):
            v["params"][name] = {
                k: (rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
                    if k.startswith("w_") else x) for k, x in sub.items()}
    return det, v


def port_config(jax_cfg):
    """The port's EfficientDetConfig with the JAX one's fields."""
    return pcfg.EfficientDetConfig(**dataclasses.asdict(jax_cfg))


def calibrate(variables, cfg, images):
    """``variables`` with every running statistic set to the batch
    statistics of ``images`` (flax's biased variance)."""
    port = efficientdet_from_jax(variables, port_config(cfg), device="cpu")
    norms = [m for m in port.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    port.train()
    with torch.no_grad():
        port(torch.from_numpy(images))
    sd = port.state_dict()
    leaf = {"mean": "running_mean", "var": "running_var"}

    def fill(tree, prefix):
        return {k: fill(v, prefix + (k,)) if hasattr(v, "items") else
                sd[".".join(prefix + (leaf[k],))].numpy().copy()
                for k, v in tree.items()}

    return {"params": variables["params"],
            "batch_stats": fill(variables["batch_stats"], ())}


def with_prior(variables, scale):
    """The classifier header at the prior bias -4.59, its kernel scaled
    by ``scale`` (how many anchors clear score_thresh). The square
    anchors of the three octaves (0, 3, 6) share anchor 0's class and box
    channels, their class biases 0.5 above the prior and 0.05 apart:
    where one clears the threshold the others come close, on boxes of
    about one center whose IoU (0.63 an octave apart, 0.40 two apart,
    before the deltas) straddles nms_thresh, so NMS has work."""
    params = dict(variables["params"])
    for name in ("classifier", "regressor"):
        pw = params[name]["head"]["pw"]
        kernel, bias = pw["kernel"].copy(), pw["bias"].copy()
        k = kernel.shape[-1] // 9
        if name == "classifier":
            kernel *= np.float32(scale)
            bias[:] = ped.PRIOR_BIAS
            bias[:k] += 0.5
        for i, a in enumerate((3, 6)):
            kernel[..., a * k:(a + 1) * k] = kernel[..., :k]
            bias[a * k:(a + 1) * k] = bias[:k] - (
                0.05 * (i + 1) if name == "classifier" else 0.0)
        params[name] = {**params[name], "head": {
            **params[name]["head"], "pw": {"kernel": kernel, "bias": bias}}}
    return {"params": params, "batch_stats": variables["batch_stats"]}


def images(seed, n=2):
    return np.random.RandomState(seed).rand(n, S, S, 3).astype(np.float32)


def separated(port, x, cfg):
    """The candidates above score_thresh of every image, and True when no
    two of them, and none and the threshold, lie within TIE_GAP."""
    with torch.no_grad():
        cls, _, _ = port(torch.from_numpy(x))
    counts, ok = [], True
    for s in torch.sigmoid(cls).amax(-1).numpy():
        cand = np.sort(s[s > cfg.score_thresh])
        counts.append(len(cand))
        ok &= len(cand) < cfg.pre_nms_top_n and (
            len(cand) == 0 or np.diff(
                np.concatenate([[cfg.score_thresh], cand])).min() > TIE_GAP)
    return counts, ok


def serving_case(jax_cfg, seed, scale):
    """(JAX detector, variables, port detector) with the statistics
    calibrated on 8 other images (on the 2 test images alone the 1x1 P7
    map's statistics come from 2 values, and normalising by them lifts
    the two programs' f32 differences to 3e-4 of P7's max abs) and the
    prior on the classifier."""
    det, v = jax_variables(jax_cfg, seed)
    v = with_prior(calibrate(v, jax_cfg, images(100, 8)), scale)
    return det, v, efficientdet_from_jax(v, port_config(jax_cfg),
                                         device="cpu")


@pytest.fixture(scope="module")
def tiny():
    x = images(1)
    det, v, port = serving_case(jed.EFFICIENTDET_TINY, 5, 0.7)

    def trunk(m, x):
        feats = m.backbone(x, False)
        outs = [feats]
        for layer in m.bifpn:
            feats = layer(feats, False)
            outs.append(feats)
        return outs

    feats = jax.jit(lambda v, x: det.module.apply(v, x, method=trunk))(v, x)
    pred = jax.jit(det.predict)(v, x)
    return {"det": det, "variables": v, "port": port, "images": x,
            "feats": jax.device_get(feats), "predict": jax.device_get(pred)}


def assert_predict_close(got, want):
    """Valid and labels exact, scores within 1e-5, valid boxes within
    1e-3 px (an invalid slot's box is whichever candidate sorts there)."""
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["labels"].dtype == np.int32
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    v = want["valid"]
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("name", ["EFFICIENTDET_D0", "EFFICIENTDET_D3",
                                  "EFFICIENTDET_TINY"])
def test_configs_and_scaling_match_jax(name):
    """Every field of each preset, in order (the anchor ratio and octave
    order fixes the head's channel layout), and the compound scaling."""
    got, want = getattr(pcfg, name), getattr(jed, name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert pen.B0_BLOCKS == jen.B0_BLOCKS
    for f in (16, 24, 32, 40, 80, 112, 192, 320):
        assert pen.round_filters(f, got.width_mult) == \
            jen.round_filters(f, want.width_mult)
    for r in (1, 2, 3, 4):
        assert pen.round_repeats(r, got.depth_mult) == \
            jen.round_repeats(r, want.depth_mult)


def test_same_padding_matches_flax():
    """TF-SAME padding: strided depthwise convolutions (k 3 and 5, even
    and odd extents) and the 3x3/2 max pool against flax's."""
    rng = np.random.RandomState(0)
    for k, n in ((3, 16), (3, 15), (5, 16), (5, 9)):
        x = rng.randn(1, n, n + 2, 4).astype(np.float32)
        w = rng.randn(k, k, 1, 4).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=4)
        conv = pen.Conv2d(4, 4, k, 2, groups=4, bias=False)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)
        pooled = fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), "SAME")
        got = pen.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(pooled))


def test_backbone_and_bifpn_match_jax(tiny):
    """C3-C5 and each BiFPN layer's P3-P7 within 1e-4 of their max abs."""
    port, x = tiny["port"], torch.from_numpy(tiny["images"])
    with torch.no_grad():
        feats = port.backbone(x.permute(0, 3, 1, 2).contiguous())
        got = [feats]
        for i in range(port.config.fpn_repeats):
            feats = getattr(port, f"bifpn_{i}")(feats)
            got.append(feats)
    assert [len(g) for g in got] == [3, 5]
    for level_got, level_want in zip(got, tiny["feats"]):
        for g, w in zip(level_got, level_want):
            w = np.asarray(w)
            g = g.permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape and np.abs(w).max() > 0.1
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


def test_anchors_match_jax(tiny):
    """The anchor grid bit for bit, at the tiny and at D0's level
    shapes, and the port's cached device copy."""
    tiny_shapes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    d0_shapes = [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    for cfg, shapes in ((pcfg.EFFICIENTDET_TINY, tiny_shapes),
                        (pcfg.EFFICIENTDET_D0, d0_shapes)):
        got = ped.generate_det_anchors(cfg, shapes)
        want = jed.generate_det_anchors(cfg, shapes)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    port = tiny["port"]
    _, _, shapes = port(torch.from_numpy(tiny["images"][:1]))
    assert shapes == tiny_shapes
    np.testing.assert_array_equal(
        port._get_anchors(shapes, "cpu").numpy(),
        jed.generate_det_anchors(jed.EFFICIENTDET_TINY, shapes))


def test_predict_matches_jax(tiny):
    """EFFICIENTDET_TINY on two 128x128 images, K5's plain version on the
    CPU: candidates separated by more than TIE_GAP, overlapping ones
    suppressed, the padded outputs equal to the reference's."""
    port, x = tiny["port"], tiny["images"]
    counts, ok = separated(port, x, port.config)
    assert ok and min(counts) > 1, counts
    want = tiny["predict"]
    # NMS had work: fewer detections than min(candidates, 8) somewhere
    assert (want["valid"].sum(1) < np.minimum(counts, 8)).any(), counts
    assert_predict_close(port.predict(torch.from_numpy(x)), want)


def test_predict_at_d0_widths_matches_jax():
    """D0's widths (b0 trunk, 64 BiFPN channels) at TINY2's depth: the
    same check at the channel counts of the served detector."""
    jcfg = dataclasses.replace(jed.EFFICIENTDET_D0, **D0_WIDTHS)
    x = images(2)
    det, v, port = serving_case(jcfg, 1, 0.3)
    counts, ok = separated(port, x, port.config)
    assert ok and min(counts) > 0, counts
    want = jax.device_get(jax.jit(det.predict)(v, x))
    assert (want["valid"].sum(1) < np.minimum(counts, 8)).any(), counts
    assert_predict_close(port.predict(torch.from_numpy(x)), want)


def test_focal_loss_and_one_hot_match_jax():
    """The focal loss over a grid of logits and targets; ``one_hot``
    gives jax.nn.one_hot's zero row for label -1 (an image with no
    boxes), where F.one_hot raises."""
    z = np.linspace(-9, 9, 37, dtype=np.float32)
    for t in (0.0, 1.0):
        want = jed._focal_loss(jnp.asarray(z), jnp.float32(t), 0.25, 1.5)
        got = ped.focal_loss(torch.from_numpy(z), torch.tensor(t), 0.25, 1.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    labels = np.array([[-1, 0, 1, 2]])
    for n in (1, 2):
        np.testing.assert_array_equal(
            ped.one_hot(torch.from_numpy(labels), n).numpy(),
            np.asarray(jax.nn.one_hot(labels, n)))


def test_bf16_flavor_tracks_jax(tiny):
    """dtype=bfloat16: convolutions stored in bf16, BatchNorm and the
    fusion weights in f32; bf16 scores and f32 boxes. The heads against
    the JAX package's bf16 module on the same weights: within twice that
    module's own drift from the f32 heads (0.014 and 0.040 of the max
    abs here; the port's 0.019 and 0.041 from the JAX bf16 heads), as
    both round at every layer, in other orders."""
    jcfg = jed.EFFICIENTDET_TINY
    port = efficientdet_from_jax(tiny["variables"], port_config(jcfg),
                                 device="cpu", dtype=torch.bfloat16)
    assert port.backbone.stem_conv.weight.dtype == torch.bfloat16
    assert port.backbone.stem_bn.weight.dtype == torch.float32
    assert port.bifpn_0.w_td_0.dtype == torch.float32
    x = tiny["images"]
    det = jed.EfficientDet(jcfg, dtype=jnp.bfloat16)
    cls, reg, _ = jax.jit(lambda v, x: det.module.apply(v, x))(
        tiny["variables"], x)
    with torch.no_grad():
        gcls, greg, _ = port(torch.from_numpy(x))
        fcls, freg, _ = tiny["port"](torch.from_numpy(x))
    assert gcls.dtype == greg.dtype == torch.bfloat16
    for g, w, f in ((gcls, cls, fcls), (greg, reg, freg)):
        w = np.asarray(w.astype(jnp.float32))
        drift = np.abs(w - f.numpy()).max()
        assert 0 < drift < 0.1 * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2 * drift)
    out = port.predict(torch.from_numpy(x))
    assert out["scores"].dtype == torch.bfloat16
    assert out["boxes"].dtype == torch.float32


def test_detector_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ped.EfficientDet(pcfg.EFFICIENTDET_TINY)
