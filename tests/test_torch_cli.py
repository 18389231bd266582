"""The port's CLI surface (stlpose_tpu_torch/scripts, utils/arguments.py,
utils/profiling.py) and the data it adds to the training path (the
host-warp pipeline, the ClassArch records), against the JAX package.

- ``arguments.py`` parses the same argv to the same namespace (the port
  adds ``--device``).
- ``01_create_experiment.py`` as a subprocess writes the same parameter
  groups as the JAX package's ``create_experiment`` (the port adds
  ``dataset.device_warp``).
- ``StepTimer`` and ``save_timing`` on a fake clock.
- Host-warp batches, with rotation (both packages crop with
  ``cv2.warpAffine``; one decode worker each): crops, joints and
  metadata exact; normalised crops (XLA rounds the normalisation
  otherwise, by up to 4.8e-7), targets and weights within 1e-6.
- ``arch_data`` and ``combined`` records, the canonical split and the
  percentage subset.
- 01 -> 02 -> 03 of the port on the CPU (host warp, tiny HRNet), with a
  profiler trace of the first train epoch.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import stlpose_tpu.utils.profiling as jax_profiling
from stlpose_tpu.config import CONFIG as JAX_CONFIG
from stlpose_tpu.data.loaders import build_pose_records as jax_records
from stlpose_tpu.data.pipeline import PoseDataPipeline as JaxPipeline
from stlpose_tpu.utils import arguments as jax_arguments
from stlpose_tpu.utils.experiment import \
    create_experiment as jax_create_experiment
from stlpose_tpu_torch.config import CONFIG, IMAGENET_MEAN, IMAGENET_STD
from stlpose_tpu_torch.data.loaders import build_pose_records
from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
from stlpose_tpu_torch.scripts import __file__ as SCRIPTS_INIT
from stlpose_tpu_torch.utils import arguments
from stlpose_tpu_torch.utils import profiling
from stlpose_tpu_torch.utils.checkpoint import checkpoint_path
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.fixtures import make_archdata_dataset, make_coco_dataset
import tests.torch_threads  # noqa: F401  (caps torch's threads)

SCRIPTS = os.path.dirname(SCRIPTS_INIT)
AUG = {"dataset": {"scale_factor": 0.35, "rot_factor": 45, "flip": True,
                   "num_joints_half_body": 8, "prob_half_body": 0.3}}


def _script(name):
    return importlib.import_module(f"stlpose_tpu_torch.scripts.{name}")


@pytest.mark.parametrize("argv", [
    ["-d", "a"],
    ["-d", "b", "--dataset_name", "styled_coco", "--batch_size", "16",
     "--flip", "true", "--rot_factor", "30", "--learning_rate", "3e-4",
     "--scheduler", "step", "--perceptual_loss", "yes", "--lambda_D", "0.7",
     "--use_gt_bbox", "false", "--optimizer", "sgd", "--nesterov", "1"],
    ["-d", "c", "--inline_style_dir", "/styles", "--inline_style_alpha",
     "0.7", "--inline_style_apply_to_valid", "true"],
])
def test_create_experiment_arguments_match_jax(argv):
    assert vars(arguments.process_create_experiment_arguments(argv)) == \
        vars(jax_arguments.process_create_experiment_arguments(argv))


def test_directory_arguments_match_jax(tmp_path, monkeypatch):
    exp_path = create_experiment("d", root=str(tmp_path))
    argv = ["-d", exp_path, "--dataset_name", "arch_data", "--flip", "false",
            "--resume_training", "true", "--data_path", "/data"]
    for get_dataset in (False, True):
        got_path, got = arguments.get_directory_argument(
            argv if get_dataset else argv[:2], get_dataset=get_dataset)
        ref_path, ref = jax_arguments.get_directory_argument(
            argv if get_dataset else argv[:2], get_dataset=get_dataset)
        assert got_path == ref_path == exp_path
        assert got.device == "cuda"
        assert {k: v for k, v in vars(got).items() if k != "device"} == \
            vars(ref)
    # a bare directory name resolves to its newest experiment
    for cfg in (CONFIG, JAX_CONFIG):
        monkeypatch.setitem(cfg["paths"], "experiments_path", str(tmp_path))
    assert arguments.resolve_exp_path("d") == \
        jax_arguments.resolve_exp_path("d") == exp_path
    # the checkpoint must exist as the port's .pt file
    with pytest.raises(SystemExit):
        arguments.get_directory_argument(["-d", exp_path, "--checkpoint",
                                          "3"], get_checkpoint=True)
    open(checkpoint_path(exp_path, 3) + ".pt", "wb").close()
    _, args = arguments.get_directory_argument(
        ["-d", exp_path, "--checkpoint", "3", "--device", "cpu"],
        get_checkpoint=True)
    assert args.checkpoint == "3" and args.device == "cpu"


def test_create_experiment_script(tmp_path):
    env = dict(os.environ, STLPOSE_EXPERIMENTS_PATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "01_create_experiment.py"),
         "-d", "cli_test", "--batch_size", "16", "--dataset_name",
         "styled_coco", "--rot_factor", "30"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert out.returncode == 0, out.stderr
    exp_path = out.stdout.strip().splitlines()[-1]
    assert exp_path.startswith(os.path.join(str(tmp_path), "cli_test"))
    with open(os.path.join(exp_path, "experiment_parameters.json")) as f:
        got = json.load(f)
    ref_path = jax_create_experiment(
        "jax", {"batch_size": 16, "dataset_name": "styled_coco",
                "rot_factor": 30.0}, root=str(tmp_path))
    with open(os.path.join(ref_path, "experiment_parameters.json")) as f:
        ref = json.load(f)
    assert got["dataset"].pop("device_warp") is False
    for group in ("dataset", "model", "training", "evaluation"):
        assert got[group] == ref[group], group
    for d in ("models", "plots"):
        assert os.path.isdir(os.path.join(exp_path, d))
    assert os.path.exists(os.path.join(exp_path, "logs.txt"))


def test_step_timer_and_save_timing_match_jax(tmp_path, monkeypatch):
    ticks = list(np.cumsum([0.0, 1.0, 0.5, 0.25, 0.25, 2.0]))
    stats = {}
    for tag, mod in (("jax", jax_profiling), ("port", profiling)):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        timer = mod.StepTimer()
        assert timer.stats() == {"steps_per_sec": 0.0,
                                 "examples_per_sec": 0.0}
        for n in (8, 8, 8, 8, 4, 8):
            timer.tick(n)
        stats[tag] = timer.stats()
        os.makedirs(tmp_path / tag)
        for _ in range(2):
            mod.save_timing(str(tmp_path / tag), "train_epoch", stats[tag])
    monkeypatch.undo()
    assert stats["port"] == stats["jax"] == {"steps_per_sec": 1.333,
                                             "examples_per_sec": 9.3}
    blobs = [(tmp_path / t / "timing_logs.json").read_text()
             for t in ("jax", "port")]
    assert blobs[0] == blobs[1]
    assert json.loads(blobs[1]) == {"train_epoch": [stats["port"]] * 2}


def test_host_warp_batches_match_jax(tmp_path):
    """Two augmented batches (rotation, scale, flip, half-body) and one
    unaugmented batch, padded to a multiple of 3."""
    data = str(tmp_path)
    make_coco_dataset(data, n_train=5, n_val=2)
    exp = {"dataset": {"dataset_name": "coco"}, "evaluation": {}}
    recs = build_pose_records(exp, "train", data_path=data)
    ref_recs = jax_records(exp, "train", data_path=data)
    for kw in ({"is_train": True, "exp_data": AUG, "drop_last": True},
               {"is_train": False, "pad_multiple": 3}):
        ref = list(JaxPipeline(ref_recs, 4, num_workers=1, seed=5, **kw))
        got = list(PoseDataPipeline(recs, 4, num_workers=1, seed=5,
                                    device_warp=False, device="cpu", **kw))
        assert len(got) == len(ref) == (2 if kw["is_train"] else 3)
        for g, r in zip(got, ref):
            for k in ("image", "target", "target_weight"):
                assert g[k].dtype == torch.float32 and g[k].device.type == \
                    "cpu"
            # the uint8 crops exactly; their normalisation is rounded
            # differently by XLA (within an ulp)
            crops = [np.rint((np.asarray(x) * IMAGENET_STD + IMAGENET_MEAN)
                             * 255.0) for x in (g["image"], r["image"])]
            np.testing.assert_array_equal(crops[0], crops[1])
            for k in ("image", "target", "target_weight"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                           atol=1e-6, rtol=0)
            for k in ("joints", "joints_vis", "center", "scale", "score",
                      "image_id", "perceptual_loss"):
                np.testing.assert_array_equal(g[k], np.asarray(r[k]))
            assert g["n_valid"] == r["n_valid"]
    assert np.asarray(ref[0]["target"]).max() > 0.5


def _write_styled(data, split_ids):
    """Styled-COCO mapping dicts for the images of a COCO fixture (the
    styled image is the original: records only)."""
    os.makedirs(os.path.join(data, "mapping_dicts"), exist_ok=True)
    for split, ids in split_ids.items():
        with open(os.path.join(data, "mapping_dicts", f"{split}_dict_style_"
                               "redblack_alpha_0.5.json"), "w") as f:
            json.dump({"%012d" % i: "%012d.jpg" % i for i in ids}, f)


@pytest.mark.parametrize("name", ["arch_data", "combined"])
def test_archdata_records_match_jax(tmp_path, monkeypatch, name):
    data = str(tmp_path / "data")
    make_archdata_dataset(data, n_imgs=7)
    make_coco_dataset(data, n_train=2, n_val=1)
    _write_styled(data, {"train": [1, 2], "valid": [1001]})
    dicts = tmp_path / "dicts"
    os.makedirs(dicts)
    (dicts / "arch_data_det_splits.json").write_text(
        json.dumps({"test": [5, 1, 3]}))
    for cfg in (CONFIG, JAX_CONFIG):
        monkeypatch.setitem(cfg["paths"], "dict_path", str(dicts))
    exp = {"dataset": {"dataset_name": name}, "evaluation": {}}
    for split, pct in (("train", None), ("train", 50), ("valid", 50)):
        got = build_pose_records(exp, split, percentage=pct, data_path=data)
        ref = jax_records(exp, split, percentage=pct, data_path=data)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            for f in ("image", "original_image", "image_id", "score",
                      "alpha", "perceptual_loss", "character_name"):
                assert getattr(g, f) == getattr(r, f), f
            for f in ("center", "scale", "joints", "joints_vis"):
                np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
            if r.archdata_joints is None:
                assert g.archdata_joints is None
            else:
                np.testing.assert_array_equal(g.archdata_joints,
                                              r.archdata_joints)
    arch = [r for r in build_pose_records(exp, "valid", data_path=data)
            if r.character_name]
    assert [r.image_id for r in arch] == [2, 4, 6]
    with pytest.raises(ValueError, match="percentage"):
        build_pose_records(exp, "train", percentage=0, data_path=data)


def test_cli_chain_on_the_cpu(tmp_path, monkeypatch, capsys):
    """01 -> 02 (two epochs, host warp with rotation, the first train
    epoch traced) -> resume -> 03 (with ``--save true``: the evaluated
    crops drawn), in-process, on the CPU."""
    data = str(tmp_path / "data")
    make_coco_dataset(data, n_train=4, n_val=2)
    monkeypatch.setitem(CONFIG["paths"], "experiments_path",
                        str(tmp_path / "experiments"))
    for k, v in (("STLPOSE_MODEL_CONFIG", "tiny"), ("STLPOSE_PRETRAINED", ""),
                 ("STLPOSE_PROFILE", str(tmp_path / "trace"))):
        monkeypatch.setenv(k, v)
    exp_path = _script("01_create_experiment").main(
        ["-d", "chain", "--batch_size", "4", "--num_epochs", "2",
         "--save_frequency", "1", "--rot_factor", "30", "--flip", "true"])
    train = _script("02_train").main(["-d", "chain", "--data_path", data,
                                      "--device", "cpu"])
    assert train.exp_path == exp_path and not train.train_pipe.device_warp
    assert train.model.stem1.conv.weight.dtype == torch.float32
    with open(os.path.join(exp_path, "training_logs.json")) as f:
        logs = json.load(f)
    assert len(logs["loss"]["training"]) == 2
    assert np.isfinite(logs["loss"]["training"]).all()
    assert [f for f in os.listdir(tmp_path / "trace")
            if f.startswith("trace_") and f.endswith(".json")]
    monkeypatch.delenv("STLPOSE_PROFILE")

    resumed = _script("02_train").main(
        ["-d", exp_path, "--data_path", data, "--device", "cpu",
         "--checkpoint", "1", "--resume_training", "true"])
    # restored at epoch 1, step 4; then epoch 1 again (two steps)
    assert resumed.cur_epoch == 1 and resumed.state.step == 6

    monkeypatch.setenv("STLPOSE_DTYPE", "bfloat16")
    evaluate = _script("03_evaluate")
    stats = evaluate.main(["-d", exp_path, "--data_path", data, "--device",
                           "cpu", "--checkpoint", "final", "--save", "true"])
    assert stats.shape == (10,) and np.isfinite(stats).all()
    with open(os.path.join(exp_path, "evaluation_stats_coco_styles_"
                           "redblack_alpha_0.5.json")) as f:
        assert list(json.load(f)) == ["final"]
    examples = os.path.join(exp_path, "plots", "eval_examples")
    assert len(os.listdir(examples)) == 4 and all(
        f.startswith("eval_") and f.endswith(".png")
        for f in os.listdir(examples))
    capsys.readouterr()
