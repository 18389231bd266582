"""The planted cases with which ``chip_smoke.py`` holds K1 and K2 against
their plain versions on the card, held here on the CPU (plain versions)
against the JAX package: K1's ties at every merge boundary of its bulk
kernel, border peaks and constant maps against ``ops/decode.py`` and
``heatmap_peaks_pallas`` in interpret mode, exactly; K2's serving scene
and its edge cases (rotations of +-30, +-60 and 90 degrees, a crop outside
its image, a width that is no multiple of 4) against ``ops/warp.py`` run
op by op (``jax.disable_jit``, as ``tests/test_torch_warp.py`` does),
exactly. So the cases that the card checks are known to be the JAX
package's function. The scenes come from ``chip_smoke.py`` at a small
size."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.decode import decode_heatmaps as jax_decode
from stlpose_tpu.ops.decode import heatmap_argmax as jax_argmax
from stlpose_tpu.ops.pallas_decode import heatmap_peaks_pallas
from stlpose_tpu.ops.pallas_warp import crop_from_center_scale_batched_pallas
from stlpose_tpu.ops.warp import affine_warp as jax_affine_warp
from stlpose_tpu.ops.warp import crop_from_center_scale_batched as jax_crops
from stlpose_tpu_torch.kernels import decode as k1
from stlpose_tpu_torch.kernels import warp as k2
from stlpose_tpu_torch.ops import affine
import tests.torch_threads  # noqa: F401  (caps torch's threads)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

OUT_SIZES = [(48, 64), (46, 62)]     # (dst_w, dst_h); 46 is no multiple of 4


def _peaks_scene():
    hm, expect = chip_smoke.decode_scene(
        torch, "cpu", torch.Generator().manual_seed(0), N=4)
    return hm, expect, k1.heatmap_peaks_plain(hm)


def _crops_scene():
    return chip_smoke.warp_scene(torch, affine, "cpu",
                                 torch.Generator().manual_seed(1), n_img=2,
                                 S=80, K=4, out_wh=OUT_SIZES[0])


def test_planted_peaks_are_the_jax_decode():
    """Integer peaks, maxima and refined coordinates (peak + shift) equal
    ``heatmap_argmax`` and ``decode_heatmaps`` of the JAX package."""
    hm, _, (coords, maxvals, shift) = _peaks_scene()
    c_ref, m_ref = (np.asarray(a) for a in jax_argmax(jnp.asarray(hm.numpy())))
    np.testing.assert_array_equal(coords.numpy(), c_ref)
    np.testing.assert_array_equal(maxvals.numpy(), m_ref)
    rng = np.random.RandomState(2)
    center = rng.uniform(50, 350, (4, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    _, m2, refined = (np.asarray(a) for a in
                      jax_decode(jnp.asarray(hm.numpy()), center, scale))
    np.testing.assert_array_equal((coords + shift).numpy(), refined)
    np.testing.assert_array_equal(maxvals.numpy(), m2)


def test_planted_peaks_match_pallas_interpret():
    hm, _, (coords, maxvals, shift) = _peaks_scene()
    nhwc = jnp.asarray(hm.permute(0, 2, 3, 1).contiguous().numpy())
    c_pl, m_pl = (np.asarray(a) for a in
                  heatmap_peaks_pallas(nhwc, interpret=True))
    np.testing.assert_array_equal((coords + shift).numpy(), c_pl)
    np.testing.assert_array_equal(maxvals.numpy(), m_pl)


def test_planted_peaks_land_where_planted():
    """Every planted tie resolves to its lowest index, on the NCHW maps,
    on an NHWC-memory view and on a view 4 bytes into a buffer (the
    layouts that take K1's strided kernel on the card)."""
    hm, expect, ref = _peaks_scene()
    assert len(expect) >= 17
    for nj, xy in expect.items():
        assert tuple(ref[0][nj].tolist()) == xy, nj
    nhwc = hm.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    buf = torch.empty(hm.numel() + 1)
    buf[1:] = hm.reshape(-1)
    for view in (nhwc, buf[1:].view(hm.shape)):
        for g, r in zip(k1.heatmap_peaks(view), ref):
            assert torch.equal(g, r)
    # the constant map ties at every index; the all-zero map has max 0
    assert tuple(ref[0][2, 1].tolist()) == (0.0, 0.0)
    assert float(ref[1][2, 0]) == 0.0


@pytest.mark.parametrize("out_wh", OUT_SIZES)
def test_scene_crops_match_jax(out_wh):
    """The unrotated serving scene: exact against the XLA path op by op;
    1e-3 (0-255 scale) against the Pallas kernel in interpret mode."""
    images, centers, scales, img_idx, _ = _crops_scene()
    params = chip_smoke.warp_params(torch, affine, centers, scales,
                                    torch.zeros(4), out_wh)
    got = k2.affine_crop(images, params, img_idx, out_wh).numpy()
    args = (jnp.asarray(images.numpy()), centers.numpy(), scales.numpy(),
            jnp.asarray(img_idx.numpy()), out_wh)
    with jax.disable_jit():
        ref = np.asarray(jax_crops(*args, use_pallas=False))
    np.testing.assert_array_equal(got, ref)
    assert 0.01 < (ref == 0).mean() < 0.99   # boxes straddle the border
    if out_wh == OUT_SIZES[0]:
        with jax.disable_jit():
            pal = np.asarray(crop_from_center_scale_batched_pallas(
                *args, interpret=True))
        np.testing.assert_allclose(got, pal, atol=1e-3, rtol=0)


@pytest.mark.parametrize("out_wh", OUT_SIZES)
def test_rotated_edge_crops_match_jax_affine_warp(out_wh):
    """The rotated edge crops (+-30, +-60, 90 degrees) equal the JAX
    package's direct bilinear ``affine_warp`` op by op."""
    scene = _crops_scene()
    images = scene[0]
    centers, scales, rot, idx, params = chip_smoke.warp_edge_cases(
        torch, affine, scene, out_wh)
    n = len(chip_smoke.ROTATIONS)
    got = k2.affine_crop(images, params, idx, out_wh)[:n].numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_affine_warp(
            jnp.asarray(images[idx[:n].long()].numpy()), centers[:n].numpy(),
            scales[:n].numpy(), rot[:n].numpy(), out_wh))
    np.testing.assert_array_equal(got, ref)
    assert (ref != 0).mean() > 0.2


def test_edge_crops_outside_or_badly_indexed_read_zeros():
    """A crop far outside its image matches JAX (all zeros); img_idx -1
    and B read zeros only (the port's rule: JAX's gather would wrap or
    clamp the index)."""
    scene = _crops_scene()
    images = scene[0]
    centers, scales, _, idx, params = chip_smoke.warp_edge_cases(
        torch, affine, scene, OUT_SIZES[1])
    got = k2.affine_crop(images, params, idx, OUT_SIZES[1])
    assert tuple(idx[-2:].tolist()) == (-1, images.shape[0])
    assert not bool(got[-3:].any())
    with jax.disable_jit():
        ref = np.asarray(jax_crops(
            jnp.asarray(images.numpy()), centers[-3:-2].numpy(),
            scales[-3:-2].numpy(), jnp.asarray(idx[-3:-2].numpy()),
            OUT_SIZES[1], use_pallas=False))
    np.testing.assert_array_equal(got[-3:-2].numpy(), ref)
