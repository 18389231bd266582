"""The bf16 serving modules: HRNet (folded) and the detector (folded trunk,
int8 RoI patch pyramid) in bfloat16, the port against the JAX package on
the same converted weights (HRNET_TINY, FASTER_RCNN_TINY).

Bound, for every comparison here. Both programs round each convolution
or dense output, each ReLU and each residual or top-down sum to bf16, but
at different points (a bias added before or after the rounding, sums
taken in another order inside each convolution), so each sits off the f32
network by its own accumulated rounding. E, the JAX bf16 program's
largest distance from the JAX f32 program on the same inputs, measures
that accumulation; it must be positive and at most 5% of the output's
largest magnitude. The port's bf16 output must lie within 2E of the JAX
bf16 output, and between 0.4E and 2E of the f32 output: as far from the
exact network as the reference's bf16 program is, so neither a different
function nor a program that skips bf16 roundings.

Readings on the CPU over the 19 outputs of this file (heatmaps, P2..P6,
RPN logits and deltas, box-head logits and deltas): E is 0.7-3.3% of the
largest magnitude, |port - JAX bf16| is 0.72-1.34 E and |port - JAX f32|
is 0.67-1.22 E. The bounds leave room of 1.5x (5% and 2E) and 1.7x (0.4E);
the port's HRNet run in f32 reads 4.5e-5 E and fails, as the test
checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import stlpose_tpu.ops.pallas_roi as jax_pallas_roi
from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu.models.faster_rcnn import FasterRCNNModule
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu.models.hrnet import fold_batchnorms as jax_fold
from stlpose_tpu.models.quantize import fold_frcnn_trunk as jax_fold_frcnn
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax)
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import jax_hrnet


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _assert_bf16_bound(got, ref_bf16, ref_f32, max_share=0.05):
    """|got - ref_bf16| <= 2E and 0.4E <= |got - ref_f32| <= 2E, E =
    max|ref_bf16 - ref_f32|, which must be positive (a bf16 program) and at
    most ``max_share`` of the output's largest magnitude."""
    E = np.abs(ref_bf16 - ref_f32).max()
    scale = np.abs(ref_f32).max()
    assert 0 < E <= max_share * scale, (E, scale)
    to_bf16 = np.abs(got - ref_bf16).max()
    to_f32 = np.abs(got - ref_f32).max()
    assert to_bf16 <= 2 * E, (to_bf16, E)
    assert 0.4 * E <= to_f32 <= 2 * E, (to_f32, E)


def test_hrnet_bf16_folded_matches_jax():
    """Folded HRNet in bf16 on three crops: heatmaps (cast to f32 at the
    end on both sides). The same port in f32 fails the bound's lower
    side."""
    _, v = jax_hrnet("tiny", 0)
    x = np.random.RandomState(1).randn(3, 256, 192, 3).astype(np.float32)
    refs = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        model = JaxHRNet(config=jax_hrnet_config("tiny"), dtype=dtype,
                         folded=True)
        refs[dtype] = _f32(jax.jit(lambda v, x: model.apply(
            v, x, train=False))(jax_fold(v), x))
    port = hrnet_from_jax(v, HRNET_TINY, device="cpu", dtype=torch.bfloat16,
                          folded=True)
    assert port.stem1.conv.weight.dtype == torch.bfloat16
    assert port.stem1.bn is None
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 64, 48, 17)
    _assert_bf16_bound(got.numpy(), refs[jnp.bfloat16], refs[jnp.float32])
    port_f32 = hrnet_from_jax(v, HRNET_TINY, device="cpu", folded=True)
    with torch.inference_mode():
        got_f32 = port_f32(torch.from_numpy(x)).numpy()
    E = np.abs(refs[jnp.bfloat16] - refs[jnp.float32]).max()
    assert np.abs(got_f32 - refs[jnp.float32]).max() < 0.4 * E


def test_detector_bf16_maps_rpn_and_box_head_match_jax(monkeypatch):
    """The folded bf16 detector on two 128-px images: the FPN maps P2..P6,
    the RPN logits and deltas, and the box head's class logits and box
    deltas on fixed proposals through the int8 RoI patch pyramid (the JAX
    kernel in interpret mode). Every output stays bf16, as in JAX."""
    monkeypatch.setattr(jax_pallas_roi, "multilevel_roi_align_pallas_batched",
                        functools.partial(
                            jax_pallas_roi.multilevel_roi_align_pallas_batched,
                            interpret=True))
    _, dv = jax_detector(0)
    dvf = jax_fold_frcnn(dv)
    imgs = np.random.RandomState(1).rand(2, 128, 128, 3).astype(np.float32)
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 100, (2, 10, 2))
    props = np.concatenate([xy, np.minimum(xy + rng.uniform(4, 60, (2, 10, 2)),
                                           128)], -1).astype(np.float32)

    def run(det, v, x, p):
        feats, logits, deltas = det.module.apply(v, x, train=False)
        cls, reg = det.module.apply(v, feats[:4], p,
                                    method=FasterRCNNModule.roi_batched)
        return feats, logits, deltas, cls, reg

    refs = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        det = JaxFasterRCNN(JAX_TINY, dtype=dtype, pallas_roi=True,
                            roi_patch_quant=True, trunk_quant="folded")
        refs[dtype] = jax.tree_util.tree_map(_f32, jax.jit(
            functools.partial(run, det))(dvf, imgs, props))
    port = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu",
                                dtype=torch.bfloat16, roi_patch_quant=True,
                                trunk_quant="folded")
    with torch.inference_mode():
        feats = port.features(torch.from_numpy(imgs).permute(0, 3, 1, 2)
                              .contiguous())
        logits, deltas = port.rpn_head(feats)
        cls, reg = port.roi_batched(feats[:4], torch.from_numpy(props))
    assert all(t.dtype == torch.bfloat16 for t in feats + [cls, reg])

    def nhwc(ts):
        return [t.float().permute(0, 2, 3, 1).numpy() for t in ts]

    got = (nhwc(feats), nhwc(logits), nhwc(deltas), cls.float().numpy(),
           reg.float().numpy())
    for g, rb, rf in zip(jax.tree_util.tree_leaves(got),
                         jax.tree_util.tree_leaves(refs[jnp.bfloat16]),
                         jax.tree_util.tree_leaves(refs[jnp.float32])):
        assert g.shape == rb.shape
        _assert_bf16_bound(g, rb, rf)
