"""K3q: the port's int8 pyramid quantization (``kernels/quantize.py``'s
plain version, and ``ops/roi_align.py::quantize_levels`` dispatching to it
on the CPU) against JAX's quantization of
``stlpose_tpu/ops/pallas_roi.py:422-429``, at the serving level shapes
(P2-P5 of 100/50/25/13, one image) and C = 256, where the JAX Pallas
wrapper quantizes itself (C % 128 == 0), with planted half-steps, an
all-zero channel, a channel under the 1e-8 floor and values at +-127."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu_torch.kernels import quantize as k3q
from stlpose_tpu_torch.ops.roi_align import quantize_levels
from tests.test_torch_roi_quant import _jax_quantize

SIZES, C = (100, 50, 25, 13), 256


def _levels():
    """One image of the serving pyramid, N(0, 1), with planted cases: on
    P2 channel 0 an absmax of 127 (scale 1.0 exactly) beside +-k.5
    half-steps and -127; on P3 an all-zero channel; on P4 a channel of
    +-3e-9 (absmax under the 1e-8 floor); on P5 a channel whose absmax
    sits at both signs (+-127 after rounding)."""
    rng = np.random.RandomState(0)
    feats = [rng.randn(1, s, s, C).astype(np.float32) for s in SIZES]
    feats[0][0, 0, :8, 0] = [127.0, 2.5, -2.5, 0.5, -0.5, 1.5, 126.5, -127.0]
    feats[1][..., 5] = 0.0
    feats[2][..., 6] = np.where(rng.rand(25, 25) > 0.5, 3e-9, -3e-9)
    feats[3][0, 0, 0, 7], feats[3][0, 1, 0, 7] = 9.0, -9.0
    return feats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(dtype):
    """int8 levels and (L, C) scales equal JAX's bit for bit, from f32 maps
    and from their bf16 rounding (the bf16 serving path's input): the plain
    version and the CPU dispatch of ``ops/roi_align.py::quantize_levels``."""
    feats = _levels()
    td = getattr(torch, dtype)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    maps = [torch.from_numpy(f).to(td) for f in feats]
    rq, rs = _jax_quantize([jnp.asarray(f).astype(jd) for f in feats])
    for fn in (k3q.quantize_levels_plain, quantize_levels):
        q, s = fn(maps)
        assert s.dtype == torch.float32 and s.shape == (4, C)
        np.testing.assert_array_equal(s.numpy(), rs)
        for a, b in zip(q, rq):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), b)
    # the planted cases reached: exact scale 1, half-steps to even, +-127,
    # the all-zero channel, the floor, both ends of a channel
    assert rs[0, 0] == 1.0
    np.testing.assert_array_equal(rq[0][0, 0, :8, 0],
                                  [127, 2, -2, 0, 0, 2, 126, -127])
    assert rs[1, 5] == np.float32(1e-8) / np.float32(127.0)
    assert not rq[1][..., 5].any()
    assert rs[2, 6] == rs[1, 5] and np.abs(rq[2][..., 6]).min() > 30
    assert rq[3][0, 0, 0, 7] == 127 and rq[3][0, 1, 0, 7] == -127


def test_unsupported_dtypes_raise():
    """The kernel pair exists for float32 and bfloat16 levels, all of one
    type; anything else raises, on the CPU as on the card."""
    f32 = torch.zeros((1, 4, 4, 16))
    for maps in ([f32.half()], [f32.double()], [f32.to(torch.int8)],
                 [f32, f32.bfloat16()]):
        for fn in (k3q.quantize_levels, k3q.quantize_levels_plain,
                   quantize_levels):
            with pytest.raises(ValueError, match="no kernel"):
                fn(maps)


def test_wrapper_takes_the_plain_version_only_on_cpu():
    """A tensor that is not on the CPU goes to the kernel's checks (here a
    meta tensor, which they refuse), never to the plain version."""
    meta = torch.empty((1, 8, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k3q.quantize_levels([meta])
    assert k3q.LAUNCHES == 0


def test_int8_bit_patterns_are_exact():
    """The f32 bit identities the kernels use, for every int8 value: K3q
    stores the low byte of r + 1.5 * 2^23 as int8 r; K3 widens byte b as
    the float with bits 0x4b0000 | (b ^ 0x80), less 2^23 + 128."""
    r = np.arange(-127, 128, dtype=np.float32)
    low = ((r + np.float32(12582912.0)).view(np.uint32) & 0xff).astype(np.uint8)
    np.testing.assert_array_equal(low.view(np.int8), r.astype(np.int8))
    b = np.arange(-128, 128).astype(np.int8)
    bits = np.uint32(0x4b000000) | (b.view(np.uint8) ^ 0x80).astype(np.uint32)
    np.testing.assert_array_equal(bits.view(np.float32) -
                                  np.float32(8388736.0), b.astype(np.float32))
