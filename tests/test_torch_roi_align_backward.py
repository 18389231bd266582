"""RoIAlign's gradient (K3b's plain version and RoIAlignFunction,
stlpose_tpu_torch/kernels/roi_align.py) against jax.vjp of the JAX
package's multilevel RoIAlign, on a planted scene: boxes on every level,
boxes past the borders (samples inside and outside [-1, size]), boxes
under one map pixel, tall and wide boxes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.roi_align import (multilevel_roi_align,
                                       multilevel_roi_align_reference)
from stlpose_tpu_torch.kernels import roi_align as _k3
from stlpose_tpu_torch.ops import roi_align as roi_ops
import tests.torch_threads  # noqa: F401  (caps torch's threads)

STRIDES = (4, 8, 16, 32)
SIZES = (32, 16, 8, 4)          # P2-P5 of a 128-pixel canvas
C = 8


def planted_scene(seed=0, B=2, P=14):
    """Maps, boxes (B, P, 4) and their levels: random boxes, then per
    image a box under one P2 pixel, a tall and a wide box, boxes reaching
    past every border (some samples inside [-1, size], some outside), and
    boxes large enough (they extend past the canvas) for P4 and P5."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, s, s, C).astype(np.float32) for s in SIZES]
    xy = rng.uniform(0, 100, (B, P, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (B, P, 2))],
                           -1).astype(np.float32)
    boxes[:, :10] = np.array([
        [40.0, 40.0, 42.5, 43.0],       # under one P2 pixel
        [10.0, 2.0, 18.0, 120.0],       # tall
        [1.0, 60.0, 127.0, 70.0],       # wide
        [-6.0, -5.0, 30.0, 24.0],       # past the top-left border
        [100.0, 110.0, 140.0, 135.0],   # past the bottom-right border
        [-60.0, 20.0, 20.0, 60.0],      # far past the left border
        [-40.0, -40.0, 200.0, 190.0],   # P4, past every border
        [-200.0, -150.0, 330.0, 380.0],  # P5
        [126.0, 126.0, 131.0, 133.0],   # in the last pixel's corner
        [4.0, 4.0, 124.0, 126.0],       # P3
    ], np.float32)
    levels = roi_ops._assign_levels(torch.from_numpy(boxes), 4)
    assert set(levels.unique().tolist()) == {0, 1, 2, 3}
    return feats, boxes, levels


def jax_map_grads(fn, feats, boxes, grad):
    """Per image, jax.vjp of ``fn`` (one image's levels, (P, 4) boxes)
    -> per level (B, h, w, C)."""
    out = [[] for _ in feats]
    for b in range(boxes.shape[0]):
        _, vjp = jax.vjp(lambda *fs: fn(list(fs), jnp.asarray(boxes[b]),
                                        strides=STRIDES),
                         *[jnp.asarray(f[b]) for f in feats])
        for li, g in enumerate(vjp(jnp.asarray(grad[b]))):
            out[li].append(np.asarray(g))
    return [np.stack(o) for o in out]


@pytest.fixture(scope="module")
def scene():
    feats, boxes, levels = planted_scene()
    grad = np.random.RandomState(1).randn(
        *boxes.shape[:2], 7, 7, C).astype(np.float32)
    plain = _k3.roi_align_backward_plain(
        torch.from_numpy(grad), [f.shape for f in feats],
        torch.from_numpy(boxes), levels, STRIDES)
    return feats, boxes, levels, grad, [g.numpy() for g in plain]


@pytest.mark.parametrize("fn", [multilevel_roi_align,
                                multilevel_roi_align_reference],
                         ids=["banded", "reference"])
def test_plain_backward_matches_jax_vjp(scene, fn):
    """Every level's gradient within 1e-5 of its max abs: the same
    products (pooled gradient x 0.25 x tap weight) summed in another
    order (JAX's banded form runs them as matmuls)."""
    feats, boxes, _, grad, plain = scene
    ref = jax_map_grads(fn, feats, boxes, grad)
    for li, (got, want) in enumerate(zip(plain, ref)):
        assert got.shape == want.shape == feats[li].shape
        assert np.abs(want).max() > 0.1, li         # every level is reached
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"level {li}")


def test_function_on_cpu_equals_plain_versions(scene):
    """RoIAlignFunction on CPU tensors: the forward is roi_align_plain's,
    exactly, and the maps' gradient roi_align_backward_plain's (within
    1e-6 of its max abs: the plain version's scatter-add runs on several
    CPU threads, so two calls may sum in another order); boxes and levels
    get none."""
    feats, boxes, levels, grad, plain = scene
    maps = [torch.from_numpy(f).requires_grad_() for f in feats]
    bx = torch.from_numpy(boxes).requires_grad_()
    out = _k3.RoIAlignFunction.apply(bx, levels, STRIDES, *maps)
    want = _k3.roi_align_plain([torch.from_numpy(f) for f in feats],
                               torch.from_numpy(boxes), levels, STRIDES)
    assert torch.equal(out.detach(), want)
    out.backward(torch.from_numpy(grad))
    for m, p in zip(maps, plain):
        np.testing.assert_allclose(m.grad.numpy(), p, rtol=0,
                                   atol=1e-6 * np.abs(p).max())
    assert bx.grad is None


def test_multilevel_roi_align_routes_by_autograd(scene):
    """With grad enabled and maps that require it, the op records
    RoIAlignFunction (the boxes get no gradient); otherwise it is the bare
    K3 call, its output the same."""
    feats, boxes, _, grad, plain = scene
    maps = [torch.from_numpy(f).requires_grad_() for f in feats]
    bx = torch.from_numpy(boxes).requires_grad_()
    out = roi_ops.multilevel_roi_align(maps, bx, STRIDES)
    assert type(out.grad_fn).__name__ == "RoIAlignFunctionBackward"
    out.backward(torch.from_numpy(grad))
    for m, p in zip(maps, plain):
        np.testing.assert_allclose(m.grad.numpy(), p, rtol=0,
                                   atol=1e-6 * np.abs(p).max())
    assert bx.grad is None
    with torch.no_grad():
        bare = roi_ops.multilevel_roi_align(maps, bx, STRIDES)
    assert bare.grad_fn is None and torch.equal(bare, out.detach())


def test_backward_refuses_bf16_and_int8(scene):
    """The gradient runs for f32 maps and for bf16 maps (bf16 training),
    each of one dtype: float16 maps, a pyramid that mixes bf16 and f32
    levels, float16 gradients and the int8 patch pyramid are refused."""
    feats, boxes, levels, grad, _ = scene
    bx = torch.from_numpy(boxes)
    f16 = [torch.from_numpy(f).half().requires_grad_() for f in feats]
    mixed = [torch.from_numpy(f).requires_grad_() for f in feats]
    mixed[0] = mixed[0].detach().bfloat16().requires_grad_()
    for maps in (f16, mixed):
        with pytest.raises(ValueError, match="maps of one dtype only"):
            _k3.RoIAlignFunction.apply(bx, levels, STRIDES, *maps)
        with pytest.raises(ValueError, match="maps of one dtype only"):
            roi_ops.multilevel_roi_align(maps, bx, STRIDES)
    for dtype in (torch.float32, torch.bfloat16):
        maps = [torch.from_numpy(f).to(dtype).requires_grad_()
                for f in feats]
        with pytest.raises(ValueError, match="int8 patch pyramid"):
            roi_ops.multilevel_roi_align(maps, bx, STRIDES, patch_quant=True)
    with pytest.raises(ValueError, match="float32 or bfloat16 gradients"):
        _k3.roi_align_backward_plain(
            torch.from_numpy(grad).half(), [f.shape for f in feats], bx,
            levels, STRIDES)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        _k3.roi_align_backward(
            torch.empty((1, 5, 7, 7, 4), device=meta), [(1, 8, 8, 4)],
            torch.empty((1, 5, 4), device=meta),
            torch.empty((1, 5), dtype=torch.int32, device=meta), (4,))



def footprint(box, level, size, stride):
    """K3b's pre-pass (``kernels/csrc/roi_align_backward.cu::
    roi_backward_footprint_kernel``) in plain torch, for one box on one
    level: per axis, the pixel range (lo, hi) of its inside samples' taps,
    min i0 to max i1, and the set of those taps; None where no sample
    lies inside. K3's sample positions (``roi_align_single_level``): 14
    per axis, inside when within [-1, size]."""
    n, sr = 7, 2
    s = torch.arange(n * sr)
    pos = (s // sr).to(torch.float32) + ((s % sr).to(torch.float32) + 0.5) / sr
    b = box * (1.0 / stride)
    axes = []
    for lo, hi in ((b[0], b[2]), (b[1], b[3])):
        g = lo + pos * (torch.clamp(hi - lo, min=1.0) /
                        torch.tensor(float(n)))
        inside = (g >= -1.0) & (g <= size)
        if not inside.any():
            return None
        i0 = torch.floor(torch.clamp(g, 0.0, size - 1)).to(torch.int64)
        i1 = (i0 + 1).clamp(max=size - 1)
        taps = set(i0[inside].tolist()) | set(i1[inside].tolist())
        axes.append((int(i0[inside].min()), int(i1[inside].max()), taps))
    return axes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_support_within_footprint(seed):
    """The footprint rule K3b's gather relies on: each box's gradient (the
    plain version's, that box alone on its level) is zero outside the
    pixel range of its inside samples' taps, on every level and image,
    and falls on at most 28 columns and 28 rows (two taps of 14 samples
    an axis), whatever the box's size; a box without an inside sample has
    no gradient."""
    feats, boxes, levels = planted_scene(seed)
    shapes = [f.shape for f in feats]
    grad = torch.from_numpy(np.random.RandomState(seed + 10).randn(
        *boxes.shape[:2], 7, 7, C).astype(np.float32))
    bt = torch.from_numpy(boxes)
    spans = []
    for b in range(boxes.shape[0]):
        for p in range(boxes.shape[1]):
            alone = torch.full_like(levels, -1)
            alone[b, p] = levels[b, p]
            maps = _k3.roi_align_backward_plain(grad, shapes, bt, alone,
                                                STRIDES)
            li = int(levels[b, p])
            fp = footprint(bt[b, p], li, SIZES[li], STRIDES[li])
            for lj, m in enumerate(maps):
                support = m.abs().sum(-1) > 0               # (B, h, w)
                if lj != li or fp is None:
                    assert not support.any(), (b, p, lj)
                    continue
                (x_lo, x_hi, x_taps), (y_lo, y_hi, y_taps) = fp
                inside = torch.zeros_like(support)
                inside[b, y_lo:y_hi + 1, x_lo:x_hi + 1] = True
                assert support.any() and not (support & ~inside).any(), \
                    (b, p, fp)
                cols = set(support[b].any(0).nonzero()[:, 0].tolist())
                rows = set(support[b].any(1).nonzero()[:, 0].tolist())
                assert cols <= x_taps and rows <= y_taps, (b, p)
                assert len(x_taps) <= 28 and len(y_taps) <= 28, fp
                spans.append(max(len(cols), len(rows)))
    assert max(spans) == 28                    # the bound is reached
