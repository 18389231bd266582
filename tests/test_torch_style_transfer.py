"""The port's style transfer (stlpose_tpu_torch/models/vgg.py, adain.py,
the converters of models/convert.py and the three ``aux_*`` scripts)
against the JAX package, on the same seeded weights in Flax layout (made
with numpy, not by Flax's init) and the same inputs; the stylizer, the
decoder training and npz, the inline stylizer and the ``aux_*`` scripts
are in tests/test_torch_style_transfer_aux.py.

Tolerances (f32 on the CPU; XLA and PyTorch sum the convolutions in
other orders):
- VGG taps, 32x32: 1e-5 absolute on activations up to ~5;
- the resize to 224x224, shrinking and enlarging: 2e-5 on [0, 1] images;
- perceptual losses, ``adain``, the AdaIN losses: 1e-5 relative;
- stylized images in [0, 1]: 1e-5 absolute;
- the AdaIN losses' gradients: 1e-5 of each tensor's largest;
- three decoder training steps: losses 2e-5 relative; Adam steps each
  weight by about lr whatever the size of its gradient, so a gradient
  near zero whose rounding differs moves it the other way: each weight
  within the 2 x 3 x lr two runs can part by, their mean distance within
  1% of the mean distance moved;
- the preload's JPEGs: one grey level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import adain as jax_adain
from stlpose_tpu.models import vgg as jax_vgg
from stlpose_tpu_torch.models import adain, vgg
from stlpose_tpu_torch.models.convert import adain_decoder_from_jax, \
    vgg_from_jax
from tests.torch_style import (ENC_TAPS, decoder_params, stylizer_pair,
                               torchvision_state, vgg_params)
import tests.torch_threads  # noqa: F401  (caps torch's threads)


@pytest.fixture(scope="module")
def weights():
    enc = vgg_params(1, n_convs=7)
    dec = decoder_params(2)
    jax_stylizer, stylizer = stylizer_pair(enc, dec)
    return {"vgg": vgg_params(0), "enc": enc, "dec": dec,
            "jax_stylizer": jax_stylizer, "stylizer": stylizer}


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_vgg_features_match_jax(weights, rng):
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    ref = jax_vgg.VGG16Features(taps=(1, 3, 6, 9)).apply(
        weights["vgg"], jnp.asarray(x))
    port = vgg_from_jax(weights["vgg"], (1, 3, 6, 9), "cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)
    assert np.asarray(ref[-1]).max() > 1.0


def test_torchvision_loader_matches_jax(weights, rng):
    """The port's torchvision loader, on tensors and on numpy arrays,
    against ``torch_vgg16_to_flax`` (taps to relu3_3; extra keys of the
    state dict ignored)."""
    state = torchvision_state(weights["vgg"])
    state["classifier.0.weight"] = torch.zeros(2, 2)
    ref_vars = jax_vgg.torch_vgg16_to_flax(
        {k: v.numpy() for k, v in state.items()}, taps=ENC_TAPS)
    x = rng.rand(1, 32, 32, 3).astype(np.float32)
    ref = jax_vgg.VGG16Features(taps=ENC_TAPS).apply(ref_vars, jnp.asarray(x))
    for st in (state, {k: v.numpy() for k, v in state.items()}):
        port = vgg.vgg16_from_torchvision(st, ENC_TAPS, "cpu")
        assert port.taps == ENC_TAPS and not hasattr(port, "conv7")
        np.testing.assert_array_equal(
            port.conv6.weight.detach().numpy().transpose(2, 3, 1, 0),
            ref_vars["params"]["conv6"]["kernel"])
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("hw", [(256, 192), (40, 30)],
                         ids=["shrink", "enlarge"])
def test_resize_matches_jax(rng, hw):
    """``jax.image.resize`` antialiases when it shrinks; without
    ``antialias`` the shrink would be 0.1 away."""
    x = rng.rand(2, *hw, 3).astype(np.float32)
    ref = np.asarray(jax_vgg._resize_bilinear(jnp.asarray(x), (224, 224)))
    got = vgg.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                              (224, 224)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["per_sample", "batch", "grey",
                                  "resize_224"])
def test_perceptual_loss_matches_jax(weights, rng, case):
    channels = 1 if case == "grey" else 3
    hw = (40, 30) if case == "resize_224" else (32, 32)
    taps = (1, 3) if case == "resize_224" else (1, 3, 6, 9)
    per_sample = case != "batch"
    resize = case == "resize_224"
    inp = rng.rand(2, *hw, channels).astype(np.float32)
    tgt = np.clip(inp + rng.randn(*inp.shape).astype(np.float32) * 0.1, 0, 1)
    variables = {"params": {k: v for k, v in weights["vgg"]["params"].items()
                            if int(k[4:]) <= max(taps)}}
    ref_fn = jax_vgg.make_perceptual_loss_fn(
        jax_vgg.VGG16Features(taps=taps), variables, resize=resize,
        per_sample=per_sample)
    port_fn = vgg.make_perceptual_loss_fn(vgg_from_jax(variables, taps, "cpu"),
                                          resize=resize,
                                          per_sample=per_sample)
    ref = np.asarray(ref_fn(jnp.asarray(inp), jnp.asarray(tgt)))
    with torch.no_grad():
        got = port_fn(torch.from_numpy(inp), torch.from_numpy(tgt)).numpy()
        same = port_fn(torch.from_numpy(inp), torch.from_numpy(inp)).numpy()
    assert got.shape == ref.shape == ((2,) if per_sample else ())
    assert rel(got, ref) < 1e-5 and (ref > 0).all()
    np.testing.assert_array_equal(same, 0.0)


def test_perceptual_loss_orders_corruption(weights, rng):
    fn = vgg.make_perceptual_loss_fn(vgg_from_jax(weights["vgg"],
                                                  device="cpu"), resize=False)
    x = torch.from_numpy(rng.rand(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        assert fn(x, x + 0.01)[0] < fn(x, x + 0.2)[0]


def test_adain_matches_jax(rng):
    """NCHW features (the JAX function's NHWC inputs permuted), with a
    constant channel (its std is 0: eps keeps the division finite)."""
    c = rng.rand(2, 8, 6, 16).astype(np.float32)
    s = (rng.rand(2, 8, 6, 16) * 3 + 1).astype(np.float32)
    c[:, :, :, 3] = 0.7
    s[1, :, :, 5] = 2.0
    ref = np.asarray(jax_adain.adain(jnp.asarray(c), jnp.asarray(s)))
    got = adain.adain(torch.from_numpy(c).permute(0, 3, 1, 2),
                      torch.from_numpy(s).permute(0, 3, 1, 2)).permute(
                          0, 2, 3, 1).numpy()
    assert np.isfinite(ref).all()
    other = [k for k in range(16) if k != 3]
    assert rel(got[..., other], ref[..., other]) < 1e-5
    # the constant channel is the style's mean, but for the content mean's
    # rounding (8 ulps of 0.7 allowed) amplified by 1/sqrt(eps)
    bound = (s[..., 3].std(axis=(1, 2)) * 8 * np.spacing(np.float32(0.7)) /
             np.sqrt(1e-5))[:, None, None]
    s_mean = s[..., 3].mean(axis=(1, 2))[:, None, None]
    for g in (got, ref):
        assert (np.abs(g[..., 3] - s_mean) <= bound).all()


@pytest.mark.parametrize("recon_weight", [0.0, 1.0])
def test_adain_train_losses_match_jax(weights, rng, recon_weight):
    content = rng.rand(2, 32, 32, 3).astype(np.float32)
    style = rng.rand(2, 32, 32, 3).astype(np.float32)
    def ref_fn(params):
        total, cl, sl = jax_adain.adain_train_losses(
            jax_vgg.VGG16Features(taps=ENC_TAPS), weights["enc"],
            jax_adain.AdaINDecoder(), params, jnp.asarray(content),
            jnp.asarray(style), recon_weight=recon_weight)
        return total, (cl, sl)

    (total, (cl, sl)), ref_grads = jax.value_and_grad(
        ref_fn, has_aux=True)(weights["dec"])
    ref = (total, cl, sl)
    s = weights["stylizer"]
    decoder = adain_decoder_from_jax({"params": weights["dec"]}, "cpu")
    got = adain.adain_train_losses(
        s.encoder, decoder, torch.from_numpy(content),
        torch.from_numpy(style), recon_weight=recon_weight)
    for g, r in zip(got, ref):
        assert rel(float(g.detach()), float(r)) < 1e-5
    got[0].backward()
    for name, conv in decoder.named_children():
        assert rel(conv.weight.grad.numpy().transpose(2, 3, 1, 0),
                   ref_grads[name]["kernel"]) < 1e-5, name
        assert rel(conv.bias.grad.numpy(), ref_grads[name]["bias"]) < 1e-5
    with torch.no_grad():
        without = adain.adain_train_losses(
            s.encoder, s.decoder, torch.from_numpy(content),
            torch.from_numpy(style))[0]
    assert (float(got[0].detach()) > float(without)) == bool(recon_weight)
