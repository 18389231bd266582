"""K2's single-image entry: ``stlpose_tpu_torch/ops/warp.py::
crop_from_center_scale`` (K crops of ONE image, plain version on CPU)
against ``stlpose_tpu/ops/warp.py::crop_from_center_scale`` (XLA, op by
op) and ``ops/pallas_warp.py::crop_from_center_scale_pallas`` (interpret
mode), on the regimes of tests/test_pallas_warp.py: crops hanging off the
canvas, the smallest canvas with one channel, a 512-px canvas, and a
non-square image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.pallas_warp import crop_from_center_scale_pallas
from stlpose_tpu.ops.warp import crop_from_center_scale as jax_crop
from stlpose_tpu_torch.ops.warp import crop_from_center_scale

OUT = (192, 256)


def _regime(name):
    rng = np.random.RandomState(5)
    if name == "off_canvas":          # test_zero_padding_outside_canvas
        img = np.full((256, 256, 3), 7.0, np.float32)
        return img, np.float32([[10.0, 10.0]]), np.float32([[1.2, 1.2]])
    if name == "non_square":          # the Pallas canvas pads to 512x512
        H, W, K = 300, 420, 6
        img = (rng.rand(H, W, 3) * 255).astype(np.float32)
        cen = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], -1)
        return (img, cen.astype(np.float32),
                rng.uniform(0.3, 1.5, (K, 2)).astype(np.float32))
    s, c, n = {"s128_c1_k1": (128, 1, 1), "s512_c3_k2": (512, 3, 2)}[name]
    img = (rng.rand(s, s, c) * 255).astype(np.float32)  # test_kernel_shape_edges
    cen = rng.uniform(s * 0.3, s * 0.7, (n, 2)).astype(np.float32)
    return img, cen, np.full((n, 2), s / 800.0, np.float32)


@pytest.mark.parametrize("name", ["off_canvas", "s128_c1_k1", "s512_c3_k2",
                                  "non_square"])
def test_single_image_crops_match_jax(name):
    """Exact against the XLA path (the same f32 operations in the same
    order); 1e-3 on the 0-255 scale against the Pallas two-pass form,
    which nests the two lerps and so rounds differently. Both references
    run op by op: under ``jit`` XLA contracts the crop-parameter
    arithmetic into FMAs, which moves samples by an ulp (1.1e-2 on the
    non-square image; ROADMAP.md Queue 3)."""
    img, cen, sca = _regime(name)
    got = crop_from_center_scale(torch.from_numpy(img), torch.from_numpy(cen),
                                 torch.from_numpy(sca), OUT).numpy()
    with jax.disable_jit():
        ref = np.asarray(jax_crop(jnp.asarray(img), cen, sca, OUT,
                                  use_pallas=False))
        pal = np.asarray(crop_from_center_scale_pallas(
            jnp.asarray(img), jnp.asarray(cen), jnp.asarray(sca), OUT,
            interpret=True))
    assert got.shape == (len(cen), 256, 192, img.shape[-1])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, pal, atol=1e-3, rtol=0)
    if name == "off_canvas":
        assert got.min() == 0.0 and got.max() == 7.0
