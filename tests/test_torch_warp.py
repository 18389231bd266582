"""K2 batched affine crop: the PyTorch port (plain version on CPU) against
the JAX reference, both the XLA gather path and the Pallas kernel in
interpret mode, with boxes partly outside the image.

The reference runs op by op (``jax.disable_jit``), each operation rounded
once as its source reads, as the port does. Under ``jit`` XLA fuses the
crop-parameter and sample-position arithmetic and contracts products into
FMAs, which moves a sample point by an ulp of its position (~1e-5 px);
on these noise images, whose neighbouring pixels differ by up to 255,
that shows as up to ~5e-3 and would hide nothing but rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stlpose_tpu.ops.pallas_warp import crop_from_center_scale_batched_pallas
from stlpose_tpu.ops.warp import affine_warp as jax_affine_warp
from stlpose_tpu.ops.warp import crop_from_center_scale_batched as jax_crops
from stlpose_tpu_torch.ops.warp import (affine_warp,
                                        crop_from_center_scale_batched)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

OUT = (192, 256)
T = torch.from_numpy


def _scene(seed, B=3, H=100, W=120, K=8):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    # centres from well outside to well inside: crops hang off every edge
    cen = np.stack([rng.uniform(-30, W + 30, K),
                    rng.uniform(-30, H + 30, K)], -1).astype(np.float32)
    sca = rng.uniform(0.2, 1.2, (K, 2)).astype(np.float32)
    idx = rng.randint(0, B, K).astype(np.int32)
    return imgs, cen, sca, idx


def test_batched_crops_match_jax():
    """Exact against the XLA path (same f32 operations in the same
    order); 1e-3 on the 0-255 scale against the Pallas two-pass form,
    which nests the two lerps and so rounds differently."""
    imgs, cen, sca, idx = _scene(0)
    got = crop_from_center_scale_batched(T(imgs), T(cen), T(sca), T(idx),
                                         OUT).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_crops(jnp.asarray(imgs), cen, sca, idx, OUT,
                                   use_pallas=False))
        pal = np.asarray(crop_from_center_scale_batched_pallas(
            jnp.asarray(imgs), cen, sca, jnp.asarray(idx), OUT,
            interpret=True))
    assert got.shape == (8, 256, 192, 3)
    assert (ref == 0).mean() > 0.05          # out-of-image taps read 0
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, pal, atol=1e-3, rtol=0)


def test_rotated_warp_matches_jax():
    """General (a, b): rotated crops, one per image, against XLA's direct
    bilinear sampler; exact op by op."""
    imgs, cen, sca, _ = _scene(1, B=4, K=4)
    rot = np.array([0.0, 30.0, -75.0, 90.0], np.float32)
    got = affine_warp(T(imgs), T(cen), T(sca), T(rot), OUT).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_affine_warp(jnp.asarray(imgs), cen, sca, rot,
                                         OUT))
    np.testing.assert_array_equal(got, ref)
