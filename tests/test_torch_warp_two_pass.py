"""K4 two-pass rotated crop warp: the PyTorch port (plain version on CPU)
against ``stlpose_tpu/ops/pallas_warp.py::affine_warp_pallas`` on
high-frequency noise canvases, rotations that take the conditioning turn
included.

Interpret mode always compiles the kernel body into one XLA program (even
under ``jax.disable_jit``), and XLA contracts its position and lerp
arithmetic into FMAs: a sample moves by an ulp of its position, which on
noise shows as up to 1.2e-2 on the 0-255 scale. The port rounds each
operation once, as the kernel's source reads (and as the TPU's vector
unit, which has no FMA, runs it), so it is held at 1e-3 to the kernel
body evaluated op by op (the wrapper under ``disable_jit``, each grid
step through the module's own ``_chunked_lane_resample``), and at 2e-2 to
the compiled interpret mode. A last case pins that K2 (direct bilinear)
and K4 compute different functions for a rotated crop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stlpose_tpu.ops.pallas_warp as pallas_warp
from stlpose_tpu.ops.affine import get_affine_params as jax_affine_params
from stlpose_tpu.ops.pallas_warp import affine_warp_pallas
from stlpose_tpu_torch.kernels import warp_two_pass as _k4
from stlpose_tpu_torch.ops.affine import get_affine_params
from stlpose_tpu_torch.ops.warp import (affine_warp, affine_warp_two_pass,
                                        two_pass_params)

OUT = (192, 256)
ROTS = (0.0, 15.0, 40.0, -60.0, 75.0, 90.0, -90.0)
T = torch.from_numpy


def _scene(seed, S, C):
    """One crop per rotation of ROTS, centred inside the canvas, plus one
    crop hanging off its top-left corner (at 40 degrees)."""
    rng = np.random.RandomState(seed)
    n = len(ROTS) + 1
    imgs = (rng.rand(n, S, S, C) * 255).astype(np.float32)
    cen = rng.uniform(0.4 * S, 0.6 * S, (n, 2)).astype(np.float32)
    sca = np.full((n, 2), 0.3 * S / 200.0, np.float32)
    cen[-1] = (0.05 * S, 0.02 * S)
    rot = np.array(ROTS + (40.0,), np.float32)
    return imgs, cen, sca, rot


def _kernel_op_by_op(params, src, N, C, S, dst_h, dst_w, **_):
    """``_pallas_warp_call`` with its kernel body (``_warp_kernel``) run
    eagerly for each (crop, channel) grid step."""
    DW_pad = pallas_warp._round_up(dst_w, 128)
    DH_pad = pallas_warp._round_up(dst_h, 128)
    resample = pallas_warp._chunked_lane_resample
    row, col = (jax.lax.broadcasted_iota(jnp.int32, (S, DW_pad), d)
                .astype(jnp.float32) for d in (0, 1))
    rowT, colT = (jax.lax.broadcasted_iota(jnp.int32, (DW_pad, DH_pad), d)
                  .astype(jnp.float32) for d in (0, 1))
    crops = []
    for n in range(N):
        u, r, txr, b, a, ty = (params[n, i] for i in range(6))
        chans = []
        for c in range(C):
            h = resample(src[n, c], u * col - r * row + txr, S, S, DW_pad)
            outT = resample(h.T, b * rowT + a * colT + ty, S, DW_pad, DH_pad)
            chans.append(outT.T[:dst_h, :dst_w])
        crops.append(jnp.stack(chans, -1))
    return jnp.stack(crops)


def _pallas(imgs, cen, sca, rot, may_rotate=True, op_by_op=False):
    args = (jnp.asarray(imgs), jnp.asarray(cen), jnp.asarray(sca),
            jnp.asarray(rot), OUT)
    if not op_by_op:
        return np.asarray(affine_warp_pallas(*args, interpret=True,
                                             may_rotate=may_rotate))
    saved = pallas_warp._pallas_warp_call
    pallas_warp._pallas_warp_call = _kernel_op_by_op
    try:
        with jax.disable_jit():
            return np.asarray(affine_warp_pallas(*args, interpret=True,
                                                 may_rotate=may_rotate))
    finally:
        pallas_warp._pallas_warp_call = saved


@pytest.mark.parametrize("S,C", [(128, 1), (256, 3)])
def test_two_pass_matches_pallas(S, C):
    """Every rotation, the ±90 degree turns and the off-canvas crop: 1e-3
    on the 0-255 scale against the kernel body op by op, 2e-2 against the
    FMA-contracted interpret mode (see the module docstring)."""
    imgs, cen, sca, rot = _scene(S + C, S, C)
    ref = _pallas(imgs, cen, sca, rot, op_by_op=True)
    got = affine_warp_two_pass(T(imgs), T(cen), T(sca), T(rot), OUT).numpy()
    assert got.shape == ref.shape == (len(rot), 256, 192, C)
    params = two_pass_params(T(cen), T(sca), T(rot), S, OUT)
    assert params[:, 6].tolist() == [0, 0, 0, 1, 1, 1, 1, 0]   # turns
    assert (ref[-1] == 0).mean() > 0.3          # off-canvas taps read 0
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, _pallas(imgs, cen, sca, rot),
                               atol=2e-2, rtol=0)


def test_crop_geometry_matches_jax_at_every_rotation():
    """(a, b, tx, ty) of the crop map equal the reference's bit for bit at
    the test rotations: cos and sin go through float64 (torch's f32 sin
    is an ulp off XLA's at ±60 degrees, which moved K4's samples by up to
    9e-3 on the 0-255 scale of a 256-px noise canvas)."""
    rot = np.array(ROTS + (60.0, 89.0, -89.0), np.float32)
    cen = np.tile(np.float32([[101.5, 77.25]]), (len(rot), 1))
    sca = np.tile(np.float32([[0.61, 0.8]]), (len(rot), 1))
    with jax.disable_jit():
        ref = [np.asarray(v) for v in jax_affine_params(
            jnp.asarray(cen), jnp.asarray(sca), jnp.asarray(rot), OUT,
            inv=True)]
    got = get_affine_params(T(cen), T(sca), T(rot), OUT, inv=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def test_uint8_canvases_read_as_float():
    """The pipeline hands K4 uint8 canvases: the same crops as from their
    f32 copy, bit for bit."""
    imgs, cen, sca, rot = _scene(5, 128, 3)
    u8 = imgs.astype(np.uint8)
    got = affine_warp_two_pass(T(u8), T(cen), T(sca), T(rot), OUT)
    ref = affine_warp_two_pass(T(u8.astype(np.float32)), T(cen), T(sca),
                               T(rot), OUT)
    assert torch.equal(got, ref)


def test_may_rotate_false_at_rot0():
    """``may_rotate=False`` (an unaugmented pipeline) skips the turn test;
    at rot 0 it gives the reference's crops."""
    imgs, cen, sca, _ = _scene(7, 128, 3)
    rot = np.zeros(len(imgs), np.float32)
    ref = _pallas(imgs, cen, sca, rot, may_rotate=False, op_by_op=True)
    got = affine_warp_two_pass(T(imgs), T(cen), T(sca), T(rot), OUT,
                               may_rotate=False).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_k2_and_k4_differ_on_rotated_crops():
    """The recorded difference: on a rotated crop of noise the two-pass
    filter (K4) and direct bilinear sampling (K2) disagree by far more
    than rounding, while at rot 0 and at ±90 degrees they agree."""
    imgs, cen, sca, rot = _scene(11, 128, 3)
    args = (T(imgs), T(cen), T(sca), T(rot), OUT)
    k4 = affine_warp_two_pass(*args).numpy()
    k2 = affine_warp(*args).numpy()
    diff = np.abs(k4 - k2).reshape(len(rot), -1).max(axis=1)
    same = [i for i, r in enumerate(ROTS) if r in (0.0, 90.0, -90.0)]
    rotated = [i for i, r in enumerate(ROTS) if r not in (0.0, 90.0, -90.0)]
    assert diff[same].max() < 2e-2
    assert diff[rotated].min() > 5.0


def test_wrapper_refuses_non_cpu_tensors_it_cannot_launch():
    """For a tensor off the CPU the wrapper goes to the kernel's checks,
    never to the plain version (a meta tensor is refused)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        _k4.warp_two_pass(torch.empty((2, 128, 128, 3), device=meta),
                          torch.empty((2, 8), device=meta), OUT)
    assert _k4.LAUNCHES == 0
