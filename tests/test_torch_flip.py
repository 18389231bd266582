"""Flip utilities of the port (stlpose_tpu_torch/ops/flip.py) against
stlpose_tpu/ops/flip.py on the same seeded numpy inputs: every function,
the one-pixel shift on and off, NCHW and NHWC. Data movement plus one f32
average in the same order, so the results are equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops import flip as jax_flip
from stlpose_tpu_torch.ops import flip
import tests.torch_threads  # noqa: F401  (caps torch's threads)


def _maps(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_flip_perm_matches_jax():
    np.testing.assert_array_equal(flip.FLIP_PERM, jax_flip.FLIP_PERM)


@pytest.mark.parametrize("name,shape", [("flip_back", (3, 17, 8, 6)),
                                        ("flip_back_nhwc", (3, 8, 6, 17))])
def test_flip_back_matches_jax(name, shape):
    x = _maps(0, shape)
    got = getattr(flip, name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jax_flip, name)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("name,shape", [
    ("average_flip_tta", (2, 17, 8, 6)),
    ("average_flip_tta_nhwc", (2, 8, 6, 17))])
def test_average_flip_tta_matches_jax(name, shape, shift):
    """Column 0 of the shifted maps keeps its own value (not 0, not the
    column it would take)."""
    direct, mirrored = _maps(1, shape), _maps(2, shape)
    got = getattr(flip, name)(torch.from_numpy(direct),
                              torch.from_numpy(mirrored), shift=shift)
    ref = np.asarray(getattr(jax_flip, name)(
        jnp.asarray(direct), jnp.asarray(mirrored), shift=shift))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("cols", [2, 3])
def test_fliplr_joints_matches_jax(cols):
    rng = np.random.RandomState(3)
    joints = rng.uniform(0, 191, (4, 17, cols)).astype(np.float32)
    vis = (rng.rand(4, 17) > 0.3).astype(np.float32)
    got = flip.fliplr_joints(torch.from_numpy(joints), torch.from_numpy(vis),
                             192)
    ref = jax_flip.fliplr_joints(joints, vis, 192)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
