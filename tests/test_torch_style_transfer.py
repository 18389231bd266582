"""The port's style transfer (stlpose_tpu_torch/models/vgg.py, adain.py,
the converters of models/convert.py and the three ``aux_*`` scripts)
against the JAX package, on the same seeded weights in Flax layout (made
with numpy, not by Flax's init) and the same inputs.

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

import importlib
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import adain as jax_adain
from stlpose_tpu.models import vgg as jax_vgg
from stlpose_tpu_torch.config import default_experiment_args
from stlpose_tpu_torch.data.loaders import get_detection_dataset, load_dataset
from stlpose_tpu_torch.models import adain, vgg
from stlpose_tpu_torch.models.convert import (adain_decoder_from_jax,
                                              adain_decoder_to_flax_params,
                                              vgg_from_jax)
from tests.torch_style import (ENC_TAPS, decoder_params, stylizer_pair,
                               torchvision_state, vgg_params, write_images)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("case", ["broadcast_scalar", "per_sample",
                                  "alpha_0", "alpha_1"])
def test_stylizer_matches_jax(weights, rng, case):
    """A single style broadcast to the batch with a scalar alpha; a style
    per sample with an (N,) alpha; alpha 0 and 1."""
    content = rng.rand(3, 32, 32, 3).astype(np.float32)
    style = rng.rand(1 if case == "broadcast_scalar" else 3, 32, 32,
                     3).astype(np.float32)
    alpha = {"broadcast_scalar": 0.7, "alpha_0": 0.0, "alpha_1": 1.0,
             "per_sample": np.array([0.0, 0.5, 1.0], np.float32)}[case]
    ref = np.asarray(weights["jax_stylizer"](content, style, alpha=alpha))
    got = weights["stylizer"](content, style, alpha=alpha)
    again = weights["stylizer"](torch.from_numpy(content),
                                torch.from_numpy(style), alpha)
    assert got.shape == ref.shape == (3, 32, 32, 3)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(again.numpy(), got)
    assert got.min() >= 0.0 and got.max() <= 1.0 and got.std() > 1e-3
    if case == "alpha_1":
        zero = weights["stylizer"](content, style, alpha=0.0).numpy()
        assert np.abs(zero - got).max() > 1e-3


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


def test_train_adain_decoder_matches_jax(weights, rng):
    """Three Adam steps (lr 1e-4, recon_weight 1): the loss history and
    the final weights; the frozen encoder is unchanged."""
    batches = [(rng.rand(2, 32, 32, 3).astype(np.float32),
                rng.rand(2, 32, 32, 3).astype(np.float32))
               for _ in range(3)]
    ref_params, ref_hist = jax_adain.train_adain_decoder(
        jax_vgg.VGG16Features(taps=ENC_TAPS), weights["enc"],
        jax_adain.AdaINDecoder(), weights["dec"], iter(batches))
    encoder = vgg_from_jax(weights["enc"], ENC_TAPS, "cpu")
    decoder = adain_decoder_from_jax({"params": weights["dec"]}, "cpu")
    seen = []
    trained, hist = adain.train_adain_decoder(
        encoder, decoder, iter(batches),
        callback=lambda step, loss: seen.append((step, loss)))
    assert trained is decoder and len(hist) == len(ref_hist) == 3
    assert seen == list(enumerate(hist, start=1))
    np.testing.assert_allclose(hist, ref_hist, rtol=2e-5)
    assert hist[-1] < hist[0]
    got = adain_decoder_to_flax_params(trained)
    for name, leaves in got.items():
        for leaf, arr in leaves.items():
            ref = np.asarray(ref_params[name][leaf])
            dist = np.abs(arr - ref)
            moved = np.abs(ref - weights["dec"][name][leaf])
            assert dist.max() <= 2 * 3 * 1e-4, (name, leaf)
            assert dist.mean() <= 0.01 * moved.mean(), (name, leaf)
            assert moved.max() > 2e-4
    assert all(not p.requires_grad for p in encoder.parameters())
    np.testing.assert_array_equal(
        encoder.conv0.weight.detach().numpy().transpose(2, 3, 1, 0),
        weights["enc"]["params"]["conv0"]["kernel"])


def test_decoder_npz_both_ways(weights, rng, tmp_path):
    """The JAX stylizer loads the port's decoder file and the port loads
    the JAX file; both give the same stylized images."""
    s = weights["stylizer"]
    port_file = str(tmp_path / "port.npz")
    adain.save_decoder_npz(port_file, s.decoder)
    loaded = np.load(port_file, allow_pickle=True)["params"].item()
    assert type(loaded) is dict and sorted(loaded) == [f"dec{i}"
                                                      for i in range(6)]
    for name, leaves in weights["dec"].items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(loaded[name][leaf], arr)
    jax_file = str(tmp_path / "jax.npz")
    np.savez(jax_file, params=np.asarray(jax.tree_util.tree_map(
        np.asarray, weights["dec"]), dtype=object))
    dec = adain.load_decoder_npz(jax_file, "cpu")
    for a, b in zip(dec.parameters(), s.decoder.parameters()):
        assert torch.equal(a, b)

    content = rng.rand(2, 32, 32, 3).astype(np.float32)
    style = rng.rand(1, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jax_adain.AdaINStylizer(
        enc_variables=weights["enc"], dec_variables={"params": loaded})(
            content, style, 0.6))
    got = adain.AdaINStylizer(s.encoder, dec, device="cpu")(content, style,
                                                            0.6).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_build_inline_stylizer(weights, rng, tmp_path):
    """A style directory, ``decoder_ckpt`` and a ``vgg_weights`` .pth: the
    bank equals the JAX package's exactly and the stylizer agrees with
    the JAX one; the off switch; no card unless the CPU is asked for."""
    sdir = write_images(str(tmp_path / "styles"), rng, 3, (60, 45))
    open(os.path.join(sdir, "notes.txt"), "w").close()
    ckpt = str(tmp_path / "dec.npz")
    adain.save_decoder_npz(ckpt, weights["stylizer"].decoder)
    pth = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state(weights["enc"]), pth)
    cfg = {"style_dir": sdir, "decoder_ckpt": ckpt, "vgg_weights": pth,
           "alpha": 0.5}
    ref, ref_bank, ref_alpha = jax_adain.build_inline_stylizer(
        cfg, crop_hw=(40, 24))
    got, bank, alpha = adain.build_inline_stylizer(cfg, crop_hw=(40, 24),
                                                   device="cpu")
    assert bank.shape == (3, 40, 24, 3) and bank.dtype == np.float32
    np.testing.assert_array_equal(bank, ref_bank)
    assert alpha == ref_alpha == 0.5
    content = rng.rand(2, 40, 24, 3).astype(np.float32)
    np.testing.assert_allclose(
        got(content, bank[:2], alpha).numpy(),
        np.asarray(ref(content, ref_bank[:2], ref_alpha)), atol=1e-5, rtol=0)
    assert adain.build_inline_stylizer(None, device="cpu") == \
        adain.build_inline_stylizer({}, device="cpu") == (None, None, 1.0)
    with pytest.raises(FileNotFoundError, match="no style exemplars"):
        adain.build_inline_stylizer({"style_dir": str(tmp_path)},
                                    device="cpu")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Every new entry point runs on "cuda" unless told otherwise, and
    raises where there is no GPU (the dataset factories before they read
    any file)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = default_experiment_args()
    for make in (adain.AdaINStylizer, vgg.VGG16Features, adain.AdaINDecoder,
                 lambda: adain.build_inline_stylizer(None),
                 lambda: get_detection_dataset(exp, data_path="/none"),
                 lambda: load_dataset(exp, data_path="/none")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for name in ("aux_train_adain_decoder", "aux_styled_coco_preload"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script(name).main(["--content_dir", str(tmp_path),
                               "--style_dir", str(tmp_path), "--out", "x"]
                              if name.startswith("aux_train")
                              else ["--style_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script("aux_create_offline_perceptual_loss").main([])


def script(name):
    return importlib.import_module(f"stlpose_tpu_torch.scripts.{name}")


def jax_script(name, monkeypatch, argv):
    """Run ``scripts/<name>.py``'s ``main`` with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


def test_aux_train_adain_decoder(weights, rng, tmp_path, capsys):
    """Two steps at 32x32 on the CPU; the JAX stylizer loads the npz and
    stylizes as the port does with the trained decoder."""
    cdir = write_images(str(tmp_path / "content"), rng, 3, (48, 40), ".jpg")
    sdir = write_images(str(tmp_path / "styles"), rng, 2, (36, 50))
    pth = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state(weights["enc"]), pth)
    out = str(tmp_path / "dec.npz")
    hist = script("aux_train_adain_decoder").main(
        ["--content_dir", cdir, "--style_dir", sdir, "--out", out,
         "--steps", "2", "--batch_size", "2", "--size", "32",
         "--vgg_weights", pth, "--log_every", "1", "--device", "cpu"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert "step 2/2" in capsys.readouterr().out
    params = np.load(out, allow_pickle=True)["params"].item()
    content = rng.rand(2, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jax_adain.AdaINStylizer(
        enc_variables=weights["enc"], dec_variables={"params": params})(
            content, content[:1], 0.8))
    port = adain.AdaINStylizer(weights["stylizer"].encoder,
                               adain.load_decoder_npz(out, "cpu"),
                               device="cpu")
    np.testing.assert_allclose(port(content, content[:1], 0.8).numpy(), ref,
                               atol=1e-5, rtol=0)


def styled_layout(root, rng, ids, hw=(60, 80)):
    """original_images/train2017, the styled images and the mapping dict
    of Styled-COCO, alpha 0.5 (one mapped image has no file)."""
    import cv2

    orig = os.path.join(root, "original_images", "train2017")
    styled = os.path.join(root, "images_style_redblack_alpha_0.5", "train")
    for d in (orig, styled, os.path.join(root, "mapping_dicts")):
        os.makedirs(d, exist_ok=True)
    for i in ids:
        for d in (orig, styled):
            cv2.imwrite(os.path.join(d, "%012d.jpg" % i),
                        (rng.rand(*hw, 3) * 255).astype(np.uint8))
    mapping = {"%012d" % i: "%012d.jpg" % i for i in ids}
    mapping["%012d" % 999] = "%012d.jpg" % 999
    with open(os.path.join(root, "mapping_dicts", "train_dict_style_"
                           "redblack_alpha_0.5.json"), "w") as f:
        json.dump(mapping, f)


def test_aux_create_offline_perceptual_loss(weights, rng, tmp_path,
                                            monkeypatch, capsys):
    """Three styled images at 224x224 (full VGG16 to relu4_3), batches of
    two: the same JSON as the JAX script's."""
    data = str(tmp_path / "data")
    styled_layout(data, rng, [3, 1, 2])
    pth = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state(weights["vgg"]), pth)
    args = ["--data_path", data, "--batch_size", "2", "--vgg_weights", pth]
    jax_script("aux_create_offline_perceptual_loss", monkeypatch,
               args + ["--dict_path", str(tmp_path / "jax")])
    path = script("aux_create_offline_perceptual_loss").main(
        args + ["--dict_path", str(tmp_path / "port"), "--device", "cpu"])
    capsys.readouterr()
    name = "perceptual_loss_dict_alpha_0.5_styles_redblack.json"
    assert path == str(tmp_path / "port" / name)
    with open(path) as f:
        got = json.load(f)
    with open(tmp_path / "jax" / name) as f:
        ref = json.load(f)
    assert list(got) == list(ref) == ["%012d.jpg" % i for i in (1, 2, 3)]
    for k in ref:
        assert rel(got[k], ref[k]) < 1e-5 and ref[k] > 0


def test_aux_styled_coco_preload(weights, rng, tmp_path, monkeypatch,
                                 capsys):
    """Random alphas, five images in batches of two (the numpy draws:
    alphas, then each batch's exemplars): the same mapping JSON as the
    JAX script's, and JPEGs within one grey level of its JPEGs."""
    import cv2

    data = str(tmp_path / "data")
    styled_layout(data, rng, [5, 1, 4, 2, 3], hw=(50, 70))
    sdir = write_images(str(tmp_path / "styles"), rng, 3, (40, 40))
    ckpt = str(tmp_path / "dec.npz")
    adain.save_decoder_npz(ckpt, weights["stylizer"].decoder)
    pth = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state(weights["enc"]), pth)
    outputs = {}
    for tag in ("jax", "port"):
        root = str(tmp_path / tag)
        os.makedirs(root)
        os.symlink(os.path.join(data, "original_images"),
                   os.path.join(root, "original_images"))
        args = ["--style_dir", sdir, "--alpha", "random", "--data_path",
                root, "--batch_size", "2", "--size", "32", "--decoder_ckpt",
                ckpt, "--vgg_weights", pth]
        if tag == "jax":
            jax_script("aux_styled_coco_preload", monkeypatch, args)
        else:
            script("aux_styled_coco_preload").main(args + ["--device", "cpu"])
        with open(os.path.join(root, "mapping_dicts", "train_dict_style_"
                               "redblack_alpha_random.json")) as f:
            outputs[tag] = (json.load(f), os.path.join(
                root, "images_style_redblack_alpha_random", "train"))
    capsys.readouterr()
    (ref, ref_dir), (got, got_dir) = outputs["jax"], outputs["port"]
    assert got == ref and len(ref) == 5
    assert len({v.split("_alpha_")[1] for v in ref.values()}) > 1
    for name in ref.values():
        a = cv2.imread(os.path.join(ref_dir, name)).astype(int)
        b = cv2.imread(os.path.join(got_dir, name)).astype(int)
        assert a.shape == b.shape == (50, 70, 3)
        assert np.abs(a - b).max() <= 1, name
