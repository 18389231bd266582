"""Crop geometry and K1 heatmap decode: the PyTorch port against the JAX
reference (XLA decode and the Pallas kernel in interpret mode). On CPU
tensors the port runs K1's plain version, which the chip smoke script
holds against the CUDA kernel on the card."""

import jax.numpy as jnp
import numpy as np
import torch

from stlpose_tpu.ops.affine import coords_to_center_scale as jax_c2cs
from stlpose_tpu.ops.affine import get_affine_params as jax_params
from stlpose_tpu.ops.affine import transform_preds as jax_transform
from stlpose_tpu.ops.decode import decode_heatmaps as jax_decode
from stlpose_tpu.ops.decode import decode_heatmaps_nhwc as jax_decode_nhwc
from stlpose_tpu.ops.decode import heatmap_argmax as jax_argmax
from stlpose_tpu.ops.pallas_decode import heatmap_peaks_pallas
from stlpose_tpu_torch.ops.affine import (coords_to_center_scale,
                                          get_affine_params, transform_preds)
from stlpose_tpu_torch.ops.decode import (decode_heatmaps,
                                          decode_heatmaps_nhwc,
                                          heatmap_argmax)

T = torch.from_numpy


def test_affine_geometry_matches_jax():
    """Elementwise f32 math in the same order: 1e-6 relative (cos/sin of
    a nonzero rotation may differ by an ulp between the libraries)."""
    rng = np.random.RandomState(0)
    center = rng.uniform(0, 400, (9, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, (9, 2)).astype(np.float32)
    rot = rng.uniform(-90, 90, 9).astype(np.float32)
    rot[:3] = 0.0
    for inv in (False, True):
        ref = jax_params(center, scale, rot, (192, 256), inv=inv)
        got = get_affine_params(T(center), T(scale), T(rot), (192, 256),
                                inv=inv)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-4)
    coords = rng.uniform(0, 64, (9, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        transform_preds(T(coords), T(center), T(scale), (48, 64)).numpy(),
        np.asarray(jax_transform(coords, center, scale, (48, 64))),
        rtol=1e-6, atol=1e-4)
    boxes = np.concatenate([center, center + rng.uniform(1, 300, (9, 2))],
                           axis=1).astype(np.float32)
    for r, g in zip(jax_c2cs(boxes, 0.75),
                    coords_to_center_scale(T(boxes), 0.75)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def planted_heatmaps(seed, N=8, J=17, H=64, W=48):
    """(N, H, W, J) maps with the cases decode must get right: a tie for
    the max at two indices (the lower wins), an all-negative map (coords
    zeroed), peaks on and next to the border (no shift there), a flat
    neighbourhood (sign 0) and plain random maps."""
    rng = np.random.RandomState(seed)
    hm = rng.uniform(-0.5, 1.0, (N, H, W, J)).astype(np.float32)
    hm[0, :, :, 0] = -rng.uniform(0.1, 1.0, (H, W))       # all negative
    hm[0, 3, 31, 1] = hm[0, 5, 7, 1] = 2.0                 # tie, flat 31 < 247
    hm[0, 0, 32, 2] = hm[0, 0, 31, 2] = 2.5                # tie across lanes
    hm[1, 0, 0, 3] = 3.0                                   # corner
    hm[1, H - 1, W - 1, 4] = 3.0                           # far corner
    hm[1, 1, 20, 5] = 3.0                                  # next to border
    hm[1, 30, W - 2, 6] = 3.0                              # next to border
    hm[1, 20, 20, 7] = 3.0                                 # flat neighbours
    hm[1, 20, 19, 7] = hm[1, 20, 21, 7] = 1.0
    hm[1, 19, 20, 7] = hm[1, 21, 20, 7] = 1.0
    hm[2] = -np.abs(hm[2])                                 # whole crop <= 0
    return hm


def test_decode_matches_jax_exactly():
    """Integer peaks, maxvals and the +-0.25 shifts are exact; image-space
    keypoints differ only by f32 rounding of the affine (1e-4 px)."""
    hm = planted_heatmaps(1)
    rng = np.random.RandomState(2)
    center = rng.uniform(50, 350, (8, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (8, 2)).astype(np.float32)
    hm_njhw = np.ascontiguousarray(hm.transpose(0, 3, 1, 2))

    p_ref, m_ref, c_ref = (np.asarray(a) for a in
                           jax_decode_nhwc(jnp.asarray(hm), center, scale))
    for got in (decode_heatmaps(T(hm_njhw), T(center), T(scale)),
                decode_heatmaps_nhwc(T(hm), T(center), T(scale))):
        p, m, c = (a.numpy() for a in got)
        np.testing.assert_array_equal(c, c_ref)
        np.testing.assert_array_equal(m, m_ref)
        np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-4)
    p2, _, c2 = (np.asarray(a) for a in
                 jax_decode(jnp.asarray(hm_njhw), center, scale))
    np.testing.assert_array_equal(c2, c_ref)

    # the planted cases really are what they claim
    peaks = np.asarray(jax_argmax(jnp.asarray(hm_njhw))[0])
    assert tuple(peaks[0, 1]) == (31.0, 3.0)           # lower index wins
    assert tuple(peaks[0, 2]) == (31.0, 0.0)
    np.testing.assert_array_equal(c_ref[0, 0], 0.0)    # all-negative map
    np.testing.assert_array_equal(c_ref[2], 0.0)
    assert tuple(c_ref[1, 7]) == (20.0, 20.0)          # sign 0 both axes
    assert tuple(c_ref[1, 3]) == (0.0, 0.0)            # border: no shift

    # the Pallas kernel (interpret mode) gives the same refined peaks
    c_pl, m_pl = (np.asarray(a) for a in
                  heatmap_peaks_pallas(jnp.asarray(hm), interpret=True))
    np.testing.assert_array_equal(c_pl, c_ref)
    np.testing.assert_array_equal(m_pl, m_ref)


def test_heatmap_argmax_matches_jax_exactly():
    hm = planted_heatmaps(3).transpose(0, 3, 1, 2).copy()
    c_ref, m_ref = (np.asarray(a) for a in jax_argmax(jnp.asarray(hm)))
    c, m = (a.numpy() for a in heatmap_argmax(T(hm)))
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_array_equal(m, m_ref)
