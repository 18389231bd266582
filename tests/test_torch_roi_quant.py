"""K3 on int8 and bf16 pyramids: the port's ``quantize_levels`` and
``multilevel_roi_align(patch_quant=...)`` (plain version on CPU) against
``stlpose_tpu/ops/pallas_roi.py::multilevel_roi_align_pallas_batched``
with ``patch_quant`` in interpret mode, on the scene and box regimes of
tests/test_torch_roi_align.py (two images, C = 32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.pallas_roi import multilevel_roi_align_pallas_batched
from stlpose_tpu_torch.kernels.roi_align import roi_align_plain
from stlpose_tpu_torch.ops.roi_align import (multilevel_roi_align,
                                             quantize_levels)
from tests.test_torch_roi_align import STRIDES, _scene
import tests.torch_threads  # noqa: F401  (caps torch's threads)

# bf16 has 8 significant bits: a rounding moves a value by at most
# U = 2^-8 of its magnitude
U = 2.0 ** -8


def _jax_quantize(feats):
    """The quantization of pallas_roi.py:422-429, in JAX."""
    scales = [jnp.maximum(jnp.abs(f.astype(jnp.float32)).max(axis=(0, 1, 2)),
                          1e-8) / 127.0 for f in feats]
    q = [jnp.clip(jnp.round(f.astype(jnp.float32) / s), -127, 127)
         .astype(jnp.int8) for f, s in zip(feats, scales)]
    return [np.asarray(x) for x in q], np.asarray(jnp.stack(scales))


def _port(feats, boxes, patch_quant, dtype=torch.float32):
    return multilevel_roi_align([torch.from_numpy(f).to(dtype) for f in feats],
                                torch.from_numpy(boxes), STRIDES,
                                patch_quant).float().numpy()


def _pallas(feats, boxes, patch_quant, dtype=jnp.float32):
    return np.asarray(multilevel_roi_align_pallas_batched(
        [jnp.asarray(f).astype(dtype) for f in feats], jnp.asarray(boxes),
        STRIDES, interpret=True, patch_quant=patch_quant)).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return _scene(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_levels_equal_jax(scene, dtype):
    """int8 levels and (L, C) scales equal JAX's bit for bit, from f32 maps
    and from their bf16 rounding (true f32 divisions, round half to even,
    clip at +-127)."""
    feats, _ = scene
    # some values exactly half a step, to reach round-half-to-even
    feats = [f.copy() for f in feats]
    feats[0][0, 0, 0, :4] = [2.5, -2.5, 0.5, 127.5]
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    q, s = quantize_levels([torch.from_numpy(f).to(td) for f in feats])
    rq, rs = _jax_quantize([jnp.asarray(f).astype(jd) for f in feats])
    assert s.dtype == torch.float32 and s.shape == (4, 32)
    np.testing.assert_array_equal(s.numpy(), rs)
    for a, b in zip(q, rq):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), b)
    assert np.abs(rq[0]).max() == 127


@pytest.fixture(scope="module")
def f32_quant(scene):
    """(port, Pallas) pooled features of the scene under patch_quant, f32
    compute: one interpret-mode call, shared by the tests below."""
    feats, boxes = scene
    return _port(feats, boxes, True), _pallas(feats, boxes, True)


def test_patch_quant_f32_matches_pallas(f32_quant):
    """f32 compute on the int8 pyramid: 1e-5 absolute against the Pallas
    kernel in interpret mode, as tests/test_pallas_roi.py holds that kernel
    to its dequantized oracle; the port dequantizes each box exactly after
    pooling, in the kernel's epilogue, the kernel through its banded matmul."""
    got, ref = f32_quant
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_patch_quant_rounding_error_is_bounded(scene):
    """The int8 rounding of the features moves the pooled output by at
    most half an int8 step of the largest level's absmax (absmax / 254),
    against the unquantized port."""
    feats, boxes = scene
    err = np.abs(_port(feats, boxes, True) - _port(feats, boxes, False)).max()
    half_step = max(np.abs(f).max() for f in feats) / 254.0
    assert 0 < err <= half_step * 1.01, (err, half_step)


@pytest.mark.parametrize("patch_quant", [True, False],
                         ids=["i8_bf16", "bf16_bf16"])
def test_bf16_matches_pallas(scene, patch_quant):
    """bf16 maps (quantized to int8 or not) -> bf16 pooled features. The
    port widens the taps and rounds once, at the store (at most U of the
    value). The Pallas body rounds its lerp into a bf16 scratch, rounds its
    banded weights to bf16, rounds the matmul's result and then the 2x2
    mean, and with patch_quant the dequantized product (five roundings of
    at most U, each of a value no larger than the channel's absmax). So
    |port - Pallas| <= 6 U absmax_c per channel c, absmax over the levels."""
    feats, boxes = scene
    got = _port(feats, boxes, patch_quant, torch.bfloat16)
    ref = _pallas(feats, boxes, patch_quant, jnp.bfloat16)
    amax = np.max([np.abs(f.astype(np.float32)).max(axis=(0, 1, 2))
                   for f in feats], axis=0)                       # (C,)
    err = np.abs(got - ref)
    assert np.abs(ref).max() > 0.5
    assert (err <= 6 * U * amax).all(), (err.max(), (err / amax).max())


def test_scales_are_batch_wide(scene, f32_quant):
    """The absmax runs over the whole batch: scaling image 1 changes the
    pooled features of image 0 under patch_quant, in the port and in the
    JAX kernel alike (1e-5 apart), and leaves them unchanged without it."""
    feats, boxes = scene
    louder = [f.copy() for f in feats]
    for f in louder:
        f[1] *= 3.0
    got, ref = _port(louder, boxes, True), _pallas(louder, boxes, True)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    for before, after in zip(f32_quant, (got, ref)):      # port, JAX
        moved = np.abs(before[0] - after[0]).max()
        assert moved > 1e-3, moved
    np.testing.assert_array_equal(_port(feats, boxes, False)[0],
                                  _port(louder, boxes, False)[0])


def test_unsupported_type_combinations_raise():
    """Only the four instantiations run, and nothing is converted to f32
    behind the caller's back: an int8 pyramid needs its scales, a float
    one takes none, and the output type must be one the kernel writes."""
    boxes = torch.zeros((1, 2, 4))
    levels = torch.zeros((1, 2), dtype=torch.int32)
    f32 = [torch.zeros((1, 8, 8, 4))]
    i8 = [torch.zeros((1, 8, 8, 4), dtype=torch.int8)]
    scales = torch.ones((1, 4))
    for maps, sc, out in ((f32, None, torch.bfloat16),
                          (i8, None, torch.bfloat16),
                          (f32, scales, torch.float32),
                          ([f.half() for f in f32], None, torch.float16)):
        with pytest.raises(ValueError, match="no kernel"):
            roi_align_plain(maps, boxes, levels, (4,), sc, out)
    out = roi_align_plain(i8, boxes, levels, (4,), scales, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 7, 7, 4)
