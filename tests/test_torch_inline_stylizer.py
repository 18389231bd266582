"""The inline AdaIN stylizer of the port's pipelines (host-warp
data/pipeline.py, data/detection_dataset.py, data/loaders.py) and the
detection dataset factory, against the JAX package, on the same seeded
weights (tests/torch_style.py).

- The exemplar of each crop or canvas is drawn from the pipeline's own
  ``RandomState`` after padding, in the JAX package's place in the draw
  order: the indices are held equal exactly.
- Geometry is untouched: targets and weights equal the port's unstylized
  batch exactly (and the JAX package's within 1e-6, the host-warp bound of
  tests/test_torch_cli.py); boxes, labels and masks exactly.
- Stylized crops: normalised images within 1e-4 (stylized pixels within
  1e-5 on [0, 1], then x255 and the ImageNet normalisation); detection
  canvases within 1e-5.
- 01 --inline_style_dir -> 02 on the CPU at the tiny HRNet.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from stlpose_tpu.config import default_experiment_args as jax_default_args
from stlpose_tpu.data import detection_dataset as jax_dd
from stlpose_tpu.data.loaders import build_pose_records as jax_records
from stlpose_tpu.data.loaders import get_detection_dataset as jax_detection
from stlpose_tpu.data.loaders import load_dataset as jax_load_dataset
from stlpose_tpu.data.pipeline import PoseDataPipeline as JaxPipeline
from stlpose_tpu_torch.config import CONFIG, default_experiment_args
from stlpose_tpu_torch.data import detection_dataset as dd
from stlpose_tpu_torch.data.loaders import (build_pose_records,
                                            get_detection_dataset,
                                            load_dataset)
from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
from tests.fixtures import make_archdata_dataset, make_coco_dataset
from tests.torch_style import (decoder_params, stylizer_pair, vgg_params,
                               write_images, write_weight_files)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

AUG = {"dataset": {"scale_factor": 0.35, "rot_factor": 45, "flip": True,
                   "num_joints_half_body": 8, "prob_half_body": 0.3}}


@pytest.fixture(scope="module")
def styles():
    enc, dec = vgg_params(3, n_convs=7), decoder_params(4)
    jax_stylizer, stylizer = stylizer_pair(enc, dec)
    return {"enc": enc, "dec": dec, "jax": jax_stylizer, "port": stylizer}


class Recording:
    """A stylizer that records, for each call, the bank index of every
    exemplar it is given."""

    def __init__(self, stylizer, bank):
        self.stylizer, self.bank, self.indices = stylizer, bank, []

    def __getattr__(self, name):
        return getattr(self.stylizer, name)

    def __call__(self, content, style, alpha=1.0):
        self.indices.append([
            int(np.flatnonzero((self.bank == s).all(axis=(1, 2, 3)))[0])
            for s in (style.cpu().numpy() if torch.is_tensor(style)
                      else np.asarray(style))])
        return self.stylizer(content, style, alpha)


def to_crops(image):
    """Normalised crops -> the 0-255 scale."""
    from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    return (np.asarray(image) * IMAGENET_STD + IMAGENET_MEAN) * 255.0


@pytest.mark.parametrize("kw", [
    {"is_train": True, "exp_data": AUG, "drop_last": True},
    {"is_train": False, "pad_multiple": 3}], ids=["augmented", "padded"])
def test_host_warp_stylized_batches_match_jax(tmp_path, rng, styles, kw):
    """Five records at B = 2: two augmented batches, or three batches,
    each padded to 3 (the last from one record)."""
    data = str(tmp_path)
    make_coco_dataset(data, n_train=3, n_val=1, people_per_img=2,
                      img_hw=(160, 200))
    exp = {"dataset": {"dataset_name": "coco"}, "evaluation": {}}
    recs = build_pose_records(exp, "train", data_path=data)[:5]
    ref_recs = jax_records(exp, "train", data_path=data)[:5]
    bank = rng.rand(4, 256, 192, 3).astype(np.float32)
    rec_jax = Recording(styles["jax"], bank)
    rec_port = Recording(styles["port"], bank)
    ref = list(JaxPipeline(ref_recs, 2, num_workers=1, seed=5,
                           stylizer=rec_jax, style_bank=bank,
                           style_alpha=0.8, **kw))
    got = list(PoseDataPipeline(recs, 2, num_workers=1, seed=5,
                                device_warp=False, device="cpu",
                                stylizer=rec_port, style_bank=bank,
                                style_alpha=0.8, **kw))
    plain = list(PoseDataPipeline(recs, 2, num_workers=1, seed=5,
                                  device_warp=False, device="cpu", **kw))
    n_batches = 2 if kw["is_train"] else 3
    assert len(got) == len(ref) == len(plain) == n_batches
    assert rec_port.indices == rec_jax.indices
    assert [len(i) for i in rec_port.indices] == \
        [2 if kw["is_train"] else 3] * n_batches
    for g, r, p in zip(got, ref, plain):
        assert g["image"].dtype == torch.float32
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(r["image"]),
                                   atol=1e-4, rtol=0)
        assert np.abs(to_crops(g["image"]) - to_crops(p["image"])).mean() > 1
        for k in ("target", "target_weight"):
            np.testing.assert_array_equal(g[k].numpy(), p[k].numpy())
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       atol=1e-6, rtol=0)
        for k in ("joints", "joints_vis", "center", "scale", "score",
                  "image_id", "perceptual_loss"):
            np.testing.assert_array_equal(g[k], np.asarray(r[k]))
        assert g["n_valid"] == r["n_valid"]
    crops = to_crops(got[0]["image"])
    assert crops.min() >= -1e-3 and crops.max() <= 255 + 1e-3
    assert np.asarray(ref[0]["target"]).max() > 0.5


def test_device_warp_refuses_a_stylizer(tmp_path, rng, styles):
    make_coco_dataset(str(tmp_path), n_train=1, n_val=1)
    recs = build_pose_records({"dataset": {"dataset_name": "coco"},
                               "evaluation": {}}, "train",
                              data_path=str(tmp_path))
    with pytest.raises(ValueError, match="device_warp"):
        PoseDataPipeline(recs, 2, is_train=True, device="cpu",
                         stylizer=styles["port"],
                         style_bank=rng.rand(2, 256, 192, 3))


def inline_cfg(tmp_path, rng, styles, n=3, hw=(50, 40)):
    pth, npz = write_weight_files(str(tmp_path), styles["enc"],
                                  styles["dec"])
    sdir = write_images(str(tmp_path / "styles"), rng, n, hw)
    return {"style_dir": sdir, "vgg_weights": pth, "decoder_ckpt": npz,
            "alpha": 0.8}


@pytest.mark.parametrize("apply_to_valid", [False, True])
def test_load_dataset_wires_inline_style(tmp_path, rng, styles,
                                         apply_to_valid):
    """``dataset.inline_style`` reaches both pipelines through
    ``load_dataset`` as in the JAX package: the train pipeline stylized,
    the validation pipeline only with ``apply_to_valid``; the first batch
    of each against the JAX package's."""
    data = str(tmp_path / "data")
    make_coco_dataset(data, n_train=2, n_val=2, img_hw=(160, 200))
    cfg = {**inline_cfg(tmp_path, rng, styles),
           "apply_to_valid": apply_to_valid}
    exps = [default_experiment_args(), jax_default_args()]
    for exp in exps:
        exp["training"]["batch_size"] = 4
        exp["dataset"]["inline_style"] = cfg
    tp, vp = load_dataset(exps[0], data_path=data, num_workers=1,
                          device="cpu")
    rtp, rvp = jax_load_dataset(exps[1], data_path=data, num_workers=1)
    assert not tp.device_warp
    assert tp.stylizer is not None and tp.style_alpha == 0.8
    assert tp.style_bank.shape == (3, 256, 192, 3)
    np.testing.assert_array_equal(tp.style_bank.numpy(), rtp.style_bank)
    assert (vp.stylizer is not None) == (rvp.stylizer is not None) == \
        apply_to_valid
    exps[0]["dataset"]["inline_style"] = None
    plain_t, plain_v = load_dataset(exps[0], data_path=data, num_workers=1,
                                    device="cpu")
    assert plain_t.stylizer is None and plain_v.stylizer is None
    for pipe, ref, plain in ((tp, rtp, plain_t), (vp, rvp, plain_v)):
        g, r, p = (next(iter(x)) for x in (pipe, ref, plain))
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(r["image"]),
                                   atol=1e-4, rtol=0)
        styled = np.abs(g["image"].numpy() - p["image"].numpy()).max() > 1e-2
        assert styled == (pipe is tp or apply_to_valid)
        np.testing.assert_array_equal(g["target"].numpy(),
                                      p["target"].numpy())


def detection_data(root, rng):
    """COCO (with a crowd box and a degenerate box), Styled-COCO mapping
    dicts and perceptual losses, ClassArch detection annotations and a
    red_black folder."""
    make_coco_dataset(root, n_train=4, n_val=3, img_hw=(120, 150))
    path = os.path.join(root, "annotations", "person_keypoints_train.json")
    with open(path) as f:
        blob = json.load(f)
    blob["annotations"][0]["iscrowd"] = 1
    blob["annotations"][1]["bbox"][2] = 0.5
    blob["annotations"][3]["area"] = 0
    with open(path, "w") as f:
        json.dump(blob, f)
    make_archdata_dataset(root, n_imgs=6)
    write_images(os.path.join(root, "class_arch_data", "red_black"), rng, 3,
                 (70, 90), ".jpg")
    os.makedirs(os.path.join(root, "mapping_dicts"), exist_ok=True)
    for split, ids in (("train", (1, 2, 4)), ("valid", (1001, 1003))):
        with open(os.path.join(root, "mapping_dicts", f"{split}_dict_style_"
                               "redblack_alpha_0.5.json"), "w") as f:
            json.dump({"%012d" % i: "s_%012d.jpg" % i for i in ids}, f)
    return {"s_%012d.jpg" % i: 0.1 * i for i in (1, 2, 4)}


def assert_records_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.image, g.image_id, g.perceptual_loss) == \
            (r.image, r.image_id, r.perceptual_loss)
        for f in ("boxes", "labels", "areas", "iscrowd"):
            np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
            assert getattr(g, f).dtype == getattr(r, f).dtype


@pytest.mark.parametrize("name", ["coco", "styled_coco", "arch_data",
                                  "red_black"])
def test_detection_records_match_jax(tmp_path, rng, name):
    """``get_detection_dataset``'s records against the JAX factory's,
    train and valid, and the two record loaders called directly."""
    data = str(tmp_path)
    ploss = detection_data(data, rng)
    for split in ("train", "valid"):
        exps = [default_experiment_args(), jax_default_args()]
        for exp in exps:
            exp["dataset"]["dataset_name"] = name
            exp["training"]["batch_size"] = 2
        got = get_detection_dataset(exps[0], split, num_workers=1,
                                    data_path=data,
                                    perceptual_loss_dict=ploss,
                                    device="cpu")
        ref = jax_detection(exps[1], split, num_workers=1, data_path=data,
                            perceptual_loss_dict=ploss)
        assert_records_equal(got.records, ref.records)
        assert (got.drop_last, got.img_size, got.stylizer) == \
            (ref.drop_last, ref.img_size, None) == (split == "train", 400,
                                                    None)
    if name == "coco":
        labels = os.path.join(data, "annotations",
                              "person_keypoints_train.json")
        img_root = os.path.join(data, "original_images", "train2017")
        assert_records_equal(
            dd.load_coco_detection_records(labels, img_root),
            jax_dd.load_coco_detection_records(labels, img_root))
    if name == "arch_data":
        labels = os.path.join(data, "annotations_arch_data", "all_data.json")
        for person_filter in (None, ("column",)):
            assert_records_equal(
                dd.load_archdata_detection_records(labels, "/x",
                                                   person_filter),
                jax_dd.load_archdata_detection_records(labels, "/x",
                                                       person_filter))
    exps[0]["dataset"]["dataset_name"] = "imagenet"
    with pytest.raises(ValueError, match="not supported"):
        get_detection_dataset(exps[0], data_path=data, device="cpu")


def test_detection_pipeline_stylizer_matches_jax(tmp_path, rng, styles):
    """Through ``get_detection_dataset`` with ``dataset.inline_style``:
    three 64x64 canvases at B = 2 (the train split drops the last); the
    bank at the canvas size, the exemplar indices, the stylized canvases
    against the JAX package's, boxes, labels and masks equal to the
    unstylized batch's; valid stylized only with ``apply_to_valid``."""
    data = str(tmp_path / "data")
    make_coco_dataset(data, n_train=3, n_val=2, img_hw=(100, 130))
    cfg = inline_cfg(tmp_path, rng, styles, hw=(30, 45))
    exps = [default_experiment_args(), jax_default_args()]
    for exp in exps:
        exp["training"]["batch_size"] = 2
        exp["dataset"]["image_size"] = 64
    plain = get_detection_dataset(exps[0], "train", num_workers=1,
                                  pad_multiple=2, data_path=data,
                                  device="cpu")
    for exp in exps:
        exp["dataset"]["inline_style"] = cfg
    got = get_detection_dataset(exps[0], "train", num_workers=1,
                                pad_multiple=2, data_path=data,
                                device="cpu")
    ref = jax_detection(exps[1], "train", num_workers=1, pad_multiple=2,
                        data_path=data)
    assert got.style_bank.shape == (3, 64, 64, 3) and got.style_alpha == 0.8
    np.testing.assert_array_equal(got.style_bank.numpy(), ref.style_bank)
    got.stylizer = Recording(got.stylizer, ref.style_bank)
    ref.stylizer = Recording(ref.stylizer, ref.style_bank)
    got_b, ref_b, plain_b = (list(p) for p in (got, ref, plain))
    assert len(got_b) == len(ref_b) == len(plain_b) == 1
    assert got.stylizer.indices == ref.stylizer.indices and \
        len(got.stylizer.indices[0]) == 2
    g, r, p = got_b[0], ref_b[0], plain_b[0]
    assert g["image"].dtype == torch.float32 and g["image"].shape == \
        (2, 64, 64, 3)
    np.testing.assert_allclose(g["image"].numpy(), np.asarray(r["image"]),
                               atol=1e-5, rtol=0)
    assert np.abs(g["image"].numpy() - p["image"]).mean() > 1e-3
    for k in ("boxes", "labels", "box_mask", "scale", "image_id",
              "perceptual_loss", "n_valid"):
        np.testing.assert_array_equal(g[k], p[k])
        np.testing.assert_array_equal(g[k], r[k])
    assert get_detection_dataset(exps[0], "valid", num_workers=1,
                                 data_path=data, device="cpu").stylizer \
        is None
    cfg["apply_to_valid"] = True
    assert get_detection_dataset(exps[0], "valid", num_workers=1,
                                 data_path=data, device="cpu").stylizer \
        is not None


def test_inline_style_cli_chain_on_the_cpu(tmp_path, rng, styles,
                                           monkeypatch, capsys):
    """01 with the ``--inline_style_*`` flags -> 02 on the CPU (tiny HRNet,
    host warp, one epoch of one batch): the train pipeline is stylized
    from the experiment's parameters alone, the validation one is not."""
    data = str(tmp_path / "data")
    make_coco_dataset(data, n_train=2, n_val=2, img_hw=(160, 200))
    cfg = inline_cfg(tmp_path, rng, styles)
    monkeypatch.setitem(CONFIG["paths"], "experiments_path",
                        str(tmp_path / "experiments"))
    monkeypatch.setenv("STLPOSE_MODEL_CONFIG", "tiny")
    monkeypatch.setenv("STLPOSE_PRETRAINED", "")
    scripts = {n: importlib.import_module(f"stlpose_tpu_torch.scripts.{n}")
               for n in ("01_create_experiment", "02_train")}
    exp_path = scripts["01_create_experiment"].main(
        ["-d", "styled", "--batch_size", "4", "--num_epochs", "1",
         "--inline_style_dir", cfg["style_dir"], "--inline_style_alpha",
         "0.8", "--inline_style_vgg_weights", cfg["vgg_weights"],
         "--inline_style_decoder_ckpt", cfg["decoder_ckpt"]])
    with open(os.path.join(exp_path, "experiment_parameters.json")) as f:
        assert json.load(f)["dataset"]["inline_style"] == {
            **cfg, "apply_to_valid": False}
    trainer = scripts["02_train"].main(["-d", exp_path, "--data_path", data,
                                        "--device", "cpu"])
    capsys.readouterr()
    assert not trainer.train_pipe.device_warp
    assert trainer.train_pipe.stylizer is not None
    assert trainer.train_pipe.style_bank.shape == (3, 256, 192, 3)
    assert trainer.valid_pipe.stylizer is None
    with open(os.path.join(exp_path, "training_logs.json")) as f:
        logs = json.load(f)
    assert len(logs["loss"]["training"]) == 1
    assert np.isfinite(logs["loss"]["training"]).all()
