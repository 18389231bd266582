"""K3 multilevel FPN RoIAlign: the PyTorch port (plain version on CPU)
against the JAX reference (the all-level oracle, the XLA fast path and the
Pallas kernel in interpret mode), C = 32, on the box regimes of
tests/test_pallas_roi.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.pallas_roi import multilevel_roi_align_pallas_batched
from stlpose_tpu.ops.roi_align import _assign_levels as jax_assign_levels
from stlpose_tpu.ops.roi_align import (multilevel_roi_align,
                                       multilevel_roi_align_reference,
                                       roi_align_single_level)
from stlpose_tpu_torch.kernels.roi_align import roi_align_plain
from stlpose_tpu_torch.ops.roi_align import _assign_levels
from stlpose_tpu_torch.ops.roi_align import \
    multilevel_roi_align as port_roi_align

STRIDES = (4, 8, 16, 32)
IMG = 400


def _random_boxes(rng, P, img):
    x1 = rng.uniform(0, img - 2, P)
    y1 = rng.uniform(0, img - 2, P)
    x2 = np.minimum(x1 + rng.uniform(1, img, P), img)
    y2 = np.minimum(y1 + rng.uniform(1, img, P), img)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _regime(name, rng):
    img = float(IMG)
    return {
        "random": lambda: _random_boxes(rng, 12, IMG),
        "extreme": lambda: np.asarray([
            [0.0, 0.0, img - 1.0, 10.0], [img - 20.0, 0.0, img, img],
            [0.0, 0.0, img, img], [0.0, 100.0, img, 130.0],
            [10.0, 10.0, 11.0, 11.0], [5.0, 5.0, 5.0, 5.0]], np.float32),
        "far_edge": lambda: np.asarray([
            [370.0, 250.0, 400.0, 295.0], [170.0, 390.0, 280.0, 400.0],
            [380.0, 295.0, 400.0, 400.0], [360.0, 80.0, 400.0, 225.0],
            [390.0, 390.0, 400.0, 400.0], [0.0, 370.0, 45.0, 400.0]],
            np.float32),
        "chunk_13": lambda: _random_boxes(rng, 13, IMG),
    }[name]()


def _scene(seed, B):
    """B images of C = 32 features at the 400-px geometry, and boxes of
    every regime of tests/test_pallas_roi.py in each image: random,
    extreme aspect / edge / degenerate, far-edge level-2 windows, and an
    odd count (the Pallas chunk-boundary case)."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, (IMG + s - 1) // s, (IMG + s - 1) // s, 32)
             .astype(np.float32) for s in STRIDES]
    boxes = np.stack([np.concatenate([_regime(r, rng) for r in REGIMES])
                      for _ in range(B)])
    return feats, boxes


REGIMES = ("random", "extreme", "far_edge", "chunk_13")


def test_matches_jax_reference_and_xla():
    """1e-5 absolute against the all-level oracle and the XLA fast path.
    The reference runs op by op (``jax.disable_jit``) so its sample
    positions round as the port's do (under ``jit`` XLA contracts them
    into FMAs, an ulp of position, ~2e-5 in value); what remains is the
    order of the 2x2 mean and the fast path's banded-matmul sums."""
    feats, boxes = _scene(0, 1)
    got = port_roi_align([torch.from_numpy(f) for f in feats],
                         torch.from_numpy(boxes), STRIDES).numpy()[0]
    assert got.shape == (boxes.shape[1], 7, 7, 32)
    fb = [jnp.asarray(f[0]) for f in feats]
    with jax.disable_jit():
        ref = np.asarray(multilevel_roi_align_reference(fb, boxes[0],
                                                        STRIDES))
        xla = np.asarray(multilevel_roi_align(fb, boxes[0], STRIDES))
    assert np.abs(ref).max() > 0.5          # real values, not all zeros
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)


def test_matches_pallas_batched():
    """Two images through one batched Pallas call (interpret mode), all
    B*P boxes in one grid as on the main path; 1e-5 absolute."""
    feats, boxes = _scene(1, 2)
    got = port_roi_align([torch.from_numpy(f) for f in feats],
                         torch.from_numpy(boxes), STRIDES).numpy()
    pal = np.asarray(multilevel_roi_align_pallas_batched(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), STRIDES,
        interpret=True))
    np.testing.assert_allclose(got, pal, atol=1e-5, rtol=0)


@pytest.mark.parametrize("level", range(4))
def test_each_level_matches_single_level_reference(level):
    """The plain version with every box sent to one level (P5 included,
    which a 400-px canvas never assigns) against the reference's
    single-level RoIAlign, op by op; a box of no level pools zeros.
    1e-5 absolute: only the order of the 2x2 mean differs."""
    feats, boxes = _scene(2, 1)
    levels = np.full(boxes.shape[:2], level, np.int32)
    levels[0, -1] = -1
    got = roi_align_plain([torch.from_numpy(f) for f in feats],
                          torch.from_numpy(boxes), torch.from_numpy(levels),
                          STRIDES).numpy()[0]
    with jax.disable_jit():
        ref = np.asarray(roi_align_single_level(
            jnp.asarray(feats[level][0]), jnp.asarray(boxes[0]),
            spatial_scale=1.0 / STRIDES[level]))
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got[:-1], ref[:-1], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[-1], 0.0)


def test_level_assignment_matches_jax():
    """The canonical level of every box equals the reference's (a flip
    would be a large error, not a rounding one)."""
    rng = np.random.RandomState(5)
    boxes = np.concatenate([_random_boxes(rng, 500, IMG),
                            _regime("extreme", rng), _regime("far_edge", rng)])
    ref = np.asarray(jax_assign_levels(jnp.asarray(boxes), 4, 224.0, 4)) - 2
    got = _assign_levels(torch.from_numpy(boxes), 4).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int32))
    # a 400-px canvas never reaches P5 (sqrt(area) < 448)
    assert set(got.tolist()) == {0, 1, 2}
