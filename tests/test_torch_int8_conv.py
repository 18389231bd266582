"""K6 (the int8 convolution with its dequantize epilogue) and K6q (the
activation quantizer), kernels/int8_conv.py, on the CPU (their plain
versions), against the JAX package's ``ConvBN`` in ``quant="int8"`` and
``"int8u"`` on the same int8 variables: the int8 codes and the int32
accumulators exactly equal (the JAX side's own expressions, jitted), the
outputs within 1e-6 of their largest magnitude (XLA may contract the
epilogue's multiply and add into one FMA: one f32 ulp). Strides 1 and 2,
kernels 1 and 3, C_in = 3, inputs with planted half-steps and values
past the clip ends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from stlpose_tpu.models.hrnet import ConvBN as JaxConvBN
from stlpose_tpu_torch.kernels import int8_conv as k6
from stlpose_tpu_torch.models.convert import jax_variables_to_state_dict
from stlpose_tpu_torch.models.hrnet import ConvBN
import tests.torch_threads  # noqa: F401  (caps torch's threads)

# (C_in, C_out, kernel, stride, H, W)
SHAPES = [(3, 16, 3, 2, 17, 13), (32, 24, 3, 1, 9, 11),
          (32, 48, 1, 2, 10, 7), (16, 8, 1, 1, 6, 5), (20, 12, 3, 2, 8, 8)]
OUT_REL = 1e-6


def int8_variables(rng, cin, cout, k, quant, x):
    """Random int8 ConvBN variables (Flax layout) for input ``x``: every
    weight code, per-channel scales, ``sx`` from the input's absmax, and
    for "int8u" zero point 128 on [0, 255]."""
    unsigned = quant == "int8u"
    p = {"kernel_i8": rng.randint(-127, 128, (k, k, cin, cout))
         .astype(np.int8),
         "sw": rng.uniform(5e-4, 2e-3, cout).astype(np.float32),
         "sx": np.float32(np.abs(x).max() / (255.0 if unsigned else 127.0)),
         "bias": rng.randn(cout).astype(np.float32)}
    if unsigned:
        p.update(zp=np.float32(128.0), qlo=np.float32(0.0),
                 qhi=np.float32(255.0))
    return p


def plant_half_steps(x, sx, unsigned):
    """Half-steps (k + 0.5) * sx, exact steps and values past the clip
    ends in the first image's first channel."""
    x = x.copy()
    vals = np.array([0.5, 1.5, 2.5, 126.5, 127.0, 300.0, 254.5, 255.5],
                    np.float32)
    if not unsigned:
        vals = np.concatenate([vals, -vals])
    flat = x[0, ..., 0].reshape(-1)
    flat[:len(vals)] = vals * sx
    x[0, ..., 0] = flat.reshape(x.shape[1:3])
    return x


def jax_codes_and_acc(p, x, k, s, quant):
    """The JAX ConvBN's int8 codes (NHWC) and int32 accumulator, from its
    own expressions (stlpose_tpu/models/hrnet.py:94-123)."""
    pad = k // 2

    def f(p, x):
        if quant == "int8":
            xq = jnp.clip(jnp.round(x / p["sx"]), -127.0,
                          127.0).astype(jnp.int8)
            y = lax.conv_general_dilated(
                xq, p["kernel_i8"], (s, s), [(pad, pad), (pad, pad)],
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32)
            return xq, y
        xq = (jnp.clip(jnp.round(x / p["sx"]), p["qlo"], p["qhi"])
              - p["zp"]).astype(jnp.int8)
        xp = lax.pad(xq, (-p["zp"]).astype(jnp.int8),
                     [(0, 0, 0), (pad, pad, 0), (pad, pad, 0), (0, 0, 0)])
        y = lax.conv_general_dilated(
            xp, p["kernel_i8"], (s, s), [(0, 0), (0, 0)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        return xq, y
    xq, acc = jax.jit(f)(p, x)
    return np.asarray(xq), np.asarray(acc)


def port_scalars(sd):
    zp = sd.get("m.zp")
    return (sd["m.sx"], zp, sd.get("m.qlo"), sd.get("m.qhi"))


@pytest.mark.parametrize("quant", ["int8", "int8u"])
def test_plain_versions_match_jax_convbn(quant):
    """Every shape of SHAPES, relu on and off: K6q's codes and K6's int32
    accumulator exactly the JAX ConvBN's, its output within OUT_REL."""
    rng = np.random.RandomState(0 if quant == "int8" else 1)
    unsigned = quant == "int8u"
    for i, (cin, cout, k, s, H, W) in enumerate(SHAPES):
        x = rng.randn(2, H, W, cin).astype(np.float32) * 3.0
        if unsigned:
            x = np.maximum(x, 0.0)
        p = int8_variables(rng, cin, cout, k, quant, x)
        x = plant_half_steps(x, float(p["sx"]), unsigned)
        ref_q, ref_acc = jax_codes_and_acc(p, x, k, s, quant)
        sd = jax_variables_to_state_dict({"params": {"m": p}})
        sx, zp, qlo, qhi = port_scalars(sd)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        q = k6.quantize_activations(xt, sx, zp, qlo, qhi)
        assert q.dtype == torch.int8 and q.shape == (2, H, W, cin)
        np.testing.assert_array_equal(q.numpy(), ref_q)
        # the accumulator alone: unit scales, no bias, no ReLU
        one = torch.ones(cout)
        acc = k6.int8_conv(q, sd["m.kernel_i8"], k, s,
                           torch.tensor(1.0), one, torch.zeros(cout), zp,
                           relu=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(ref_acc).max() < 2 ** 24     # exact in f32 here
        np.testing.assert_array_equal(acc, ref_acc.astype(np.float32))
        relu = i % 2 == 0
        jm = JaxConvBN(cout, k, s, relu=relu, folded=True, quant=quant)
        ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(
            {"params": p}, x))
        m = ConvBN(cin, cout, k, s, relu=relu, folded=True, quant=quant)
        m.load_state_dict({key[2:]: v for key, v in sd.items()})
        with torch.inference_mode():
            got = m(xt).permute(0, 2, 3, 1).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=OUT_REL * np.abs(ref).max())
        assert not relu or got.min() >= 0.0


def test_bf16_input_and_output():
    """A bf16 ConvBN: codes from the bf16 input widened to f32, the output
    the f32 result rounded once to bf16 (the JAX ConvBN with
    dtype=bfloat16, within one bf16 rounding of an FMA-contracted
    epilogue)."""
    rng = np.random.RandomState(2)
    cin, cout, k, s, H, W = 32, 16, 3, 2, 9, 10
    x = rng.randn(2, H, W, cin).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    p = int8_variables(rng, cin, cout, k, "int8", x)
    jm = JaxConvBN(cout, k, s, relu=True, dtype=jnp.bfloat16, folded=True,
                   quant="int8")
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(
        {"params": p}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    sd = jax_variables_to_state_dict({"params": {"m": p}})
    m = ConvBN(cin, cout, k, s, relu=True, folded=True, quant="int8")
    m.load_state_dict({key[2:]: v for key, v in sd.items()})
    with torch.inference_mode():
        got = m(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=1e-6)
    assert (got == ref).mean() > 0.99


def test_accumulator_past_f32_exact_range():
    """K = 3 * 3 * 512 products of +-127: |acc| up to 7.4e7, above f32's
    exact-integer range; the plain version's float64 convolution gives the
    int64 sum exactly (interior pixels: all 9 taps; corners: 4)."""
    C, O = 512, 4
    x = np.full((1, 5, 5, C), 127, np.int8)
    x[..., 1::2] = -127
    w = np.full((O, C, 3, 3), 127, np.int8)
    w[1] = -127
    w[2, 1::2] = -127
    w[3, :, 1, 1] = 0
    w8 = k6.relayout_kernel_i8(torch.from_numpy(w))
    assert w8.shape == (O, 4608) and k6.padded_k(3, C) == 4608
    acc = k6.int8_conv(torch.from_numpy(x), w8, 3, 1, torch.tensor(1.0),
                       torch.ones(O), torch.zeros(O), None, relu=False)
    ref = np.zeros((O, 5, 5), np.int64)
    xp = np.pad(x[0].astype(np.int64), ((1, 1), (1, 1), (0, 0)))
    for o in range(O):
        for i in range(5):
            for j in range(5):
                ref[o, i, j] = (xp[i:i + 3, j:j + 3] *
                                w[o].astype(np.int64).transpose(1, 2, 0)).sum()
    assert np.abs(ref).max() == 9 * 512 * 127 * 127 > 2 ** 24
    np.testing.assert_array_equal(acc[0].double().numpy(),
                                  ref.astype(np.float32).astype(np.float64))


def test_weight_layout_round_trip_and_padding():
    """``relayout_kernel_i8``: (C_out, kh, kw, C_in) flattened, zeros after
    K (HRNet's stem: K = 27 -> 32); ``kernel_i8_oihw`` inverts it."""
    w = torch.randint(-127, 128, (5, 3, 3, 3), dtype=torch.int8)
    r = k6.relayout_kernel_i8(w)
    assert r.shape == (5, 32) and r.dtype == torch.int8
    assert not r[:, 27:].any()
    assert torch.equal(r[:, :27], w.permute(0, 2, 3, 1).reshape(5, 27))
    assert torch.equal(k6.kernel_i8_oihw(r, 3, 3), w)
    assert k6.padded_k(1, 64) == 64 and k6.padded_k(1, 16) == 32
