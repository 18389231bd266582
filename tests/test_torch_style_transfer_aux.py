"""The port's AdaIN stylizer, decoder training, decoder npz, inline
stylizer and the three ``aux_*`` scripts (stlpose_tpu_torch/models/
adain.py, models/convert.py, scripts/aux_*.py) against the JAX package,
on the seeded weights and tolerances of tests/test_torch_style_transfer.py
(stylized images 1e-5 absolute; three decoder training steps: losses
2e-5 relative, each weight within the 2 x 3 x lr two runs can part by;
the preload's JPEGs one grey level). Split from that file so that each
test file of the port holds at most 12 tests (pytest-xdist's
``--dist loadfile`` queues files largest first).
"""

import importlib
import importlib.util
import json
import os
import sys

import jax
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
from tests.test_torch_style_transfer import rel, weights
from tests.torch_style import ENC_TAPS, torchvision_state, write_images
import tests.torch_threads  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
