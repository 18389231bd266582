"""The port's qualitative vase engine (stlpose_tpu_torch/engines/
vase_evaluator.py::VaseEvaluator, scripts/04_evaluate_vases_qualitatively.py)
and what it stands on: the vase pipeline, the detector factory and the
detector checkpoints, against the JAX package.

- Parity: one JAX ``VaseEvaluator`` (module-scoped) and the port's
  (``device="cpu"``) on the same weights (FASTER_RCNN_TINY and
  HRNET_TINY with random weights and BatchNorm statistics; the port's
  read from its own checkpoint files) and the same seeded B = 3 batches,
  float and uint8. The reference is the JAX host path (its fused path
  needs B divisible by the 8 virtual devices). ``bbox_thr`` sits between
  two of the JAX detector's person scores near their median, so the
  per-image counts vary. Both of the port's paths are held to boxes 1e-4,
  scores 1e-5 and keypoints (x, y, score) 1e-3, the JAX package's own
  fused-vs-host tolerances. Under ``jit`` the JAX crops are contracted
  into FMAs (ROADMAP Queue 3), so the heatmaps differ by ~1e-4 relative:
  every kept score is asserted clear of its neighbours and of
  ``bbox_thr``, every heatmap peak and quarter-pixel shift decision clear
  of a tie, every maximum clear of ``kpt_thr``.
- Compaction: the batch against each image alone.
- The vase pipeline: images, scales, ids and counts equal to the JAX one.
- Rendering: the same PNG names as the JAX engine.
- The CLI on the CPU, and no run without a card. The detector factory
  (both families), the detector checkpoints and the engine on
  EfficientDet are in tests/test_torch_vase_detectors.py.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.data.loaders import get_vase_subset as jax_vase_subset
from stlpose_tpu.engines.vase_evaluator import \
    VaseEvaluator as JaxVaseEvaluator
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu.ops.affine import coords_to_center_scale as jax_cs
from stlpose_tpu.ops.warp import crop_from_center_scale_batched as jax_crop
from stlpose_tpu.parallel import get_mesh
from stlpose_tpu.parallel.detector_steps import make_detector_predict
from stlpose_tpu.parallel.steps import make_infer_fn as jax_infer_fn
from stlpose_tpu.train.state import PoseTrainState as JaxState
from stlpose_tpu.utils.experiment import \
    create_experiment as jax_create_experiment
from stlpose_tpu_torch.config import (FASTER_RCNN_TINY, HRNET_TINY,
                                      IMAGENET_MEAN, IMAGENET_STD)
from stlpose_tpu_torch.data.loaders import get_vase_subset
from stlpose_tpu_torch.engines.detector_trainer import build_detector
from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax)
from stlpose_tpu_torch.ops.affine import coords_to_center_scale
from stlpose_tpu_torch.ops.warp import crop_from_center_scale_batched
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import save_checkpoint
from stlpose_tpu_torch.utils.experiment import (create_experiment,
                                                load_experiment_parameters)
from tests.test_torch_eval_step import peak_margins
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import random_variables
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B, MAX_DETS, KPT_THR = 3, 4, 0.1
DATASET = "ccoimages_final"


def write_vases(d, n, seed=0):
    """``n`` cv2-written noise JPEGs of 200-300 x 240-320 px in ``d``."""
    import cv2
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        hw = (rng.randint(200, 300), rng.randint(240, 320), 3)
        cv2.imwrite(os.path.join(d, f"vase_{i}.jpg"),
                    rng.randint(0, 255, hw, np.uint8))


def save_port_checkpoints(exp_path, dv, pv):
    """The JAX variables ``dv`` (detector) and ``pv`` (HRNet) as the
    port experiment's detector and pose checkpoints "final"."""
    exp = load_experiment_parameters(exp_path)
    det = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu")
    save_checkpoint(create_train_state(det, exp), exp_path, "final",
                    detector=True)
    pose = hrnet_from_jax(pv, HRNET_TINY, device="cpu")
    save_checkpoint(create_train_state(pose, exp), exp_path, "final")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("vase")
    data = str(root / "data")
    write_vases(os.path.join(data, DATASET), 5)
    _, dv = jax_detector(0)
    pose = JaxHRNet(config=jax_hrnet_config("tiny"))
    import jax
    import jax.numpy as jnp
    pv = random_variables(jax.eval_shape(lambda: pose.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 192, 3)), train=False)), 1)
    jax_exp = jax_create_experiment("jax", {"batch_size": 2},
                                    root=str(root / "jax_exp"))
    port_exp = create_experiment("port", {"batch_size": 2},
                                 root=str(root / "port_exp"))
    save_port_checkpoints(port_exp, dv, pv)
    return {"root": root, "data": data, "jax_exp": jax_exp,
            "port_exp": port_exp, "dv": dv, "pv": pv}


def port_engine(ws, **kw):
    ev = VaseEvaluator(ws["port_exp"], checkpoint="final",
                       detector_checkpoint="final", dataset_name=DATASET,
                       data_path=ws["data"], max_dets=MAX_DETS,
                       kpt_thr=KPT_THR, detector_config="faster_rcnn_tiny",
                       device="cpu", **{"save": False, **kw})
    ev.load_vase_subset()
    ev.setup_models(config_name="tiny")
    return ev


def jax_engine(ws, **kw):
    """The JAX ``VaseEvaluator`` with the workspace's weights in place of
    its own initialisation (what its ``setup_models`` builds, less the
    eager Flax init, which takes ~50 s on the CPU)."""
    ev = JaxVaseEvaluator(ws["jax_exp"], dataset_name=DATASET,
                          data_path=ws["data"], max_dets=MAX_DETS,
                          kpt_thr=KPT_THR,
                          detector_config="faster_rcnn_tiny",
                          **{"save": False, **kw})
    ev.load_vase_subset()
    ev.mesh = get_mesh()
    ev.det_state = JaxState(ws["dv"]["params"], ws["dv"]["batch_stats"],
                            None, 0)
    ev.det_predict = make_detector_predict(ev.detector, ev.mesh)
    ev.pose_model = JaxHRNet(config=jax_hrnet_config("tiny"))
    ev.pose_state = JaxState(ws["pv"]["params"], ws["pv"]["batch_stats"],
                             None, 0)
    ev.pose_infer = jax_infer_fn(ev.pose_model, ev.mesh, flip_tta=False,
                                 decode=False)
    return ev


@pytest.fixture(scope="module")
def engines(workspace):
    """The JAX engine (host path) and the port's, on the same weights, with
    ``bbox_thr`` between two of the JAX detector's scores near their
    median over the float batch."""
    ws = workspace
    jev = jax_engine(ws)
    images = batches()["float"]
    pad = np.concatenate([images, np.repeat(images[-1:], 8 - B, 0)])
    dets = {k: np.asarray(v)[:B] for k, v in
            jev.det_predict(jev.det_state, pad).items()}
    s = np.sort(dets["scores"][dets["valid"] & (dets["labels"] == 1)])
    mid = len(s) // 2
    thr = float((s[mid - 1] + s[mid]) / 2)
    jev.bbox_thr = thr
    pev = port_engine(ws, bbox_thr=thr)
    return jev, pev, thr


def batches():
    rng = np.random.RandomState(12)
    S = FASTER_RCNN_TINY.image_size
    return {"float": rng.rand(B, S, S, 3).astype(np.float32),
            "uint8": rng.randint(0, 256, (B, S, S, 3), np.uint8)}


def crop_heatmaps(ev, images, results):
    """The port's (K, J, H, W) heatmaps of the crops of ``results``, and
    their largest difference from its heatmaps of the JAX package's crops
    of the same boxes."""
    imgs = (images.astype(np.float32) / 255.0 if images.dtype == np.uint8
            else images) * 255.0
    boxes = np.concatenate([r["boxes"] for r in results])
    idx = np.concatenate([np.full(len(r["boxes"]), i, np.int32)
                          for i, r in enumerate(results)])
    c, s = coords_to_center_scale(torch.from_numpy(boxes), 0.75)
    crops = crop_from_center_scale_batched(
        torch.from_numpy(imgs), c, s, torch.from_numpy(idx), (192, 256))
    jc, js = jax_cs(boxes, 0.75)
    ref = torch.from_numpy(np.array(jax_crop(imgs, jc, js, idx,
                                               (192, 256))))
    mean, std = torch.from_numpy(IMAGENET_MEAN), torch.from_numpy(
        IMAGENET_STD)
    hm = ev.pose_infer((crops / 255.0 - mean) / std)
    hm_ref = ev.pose_infer((ref / 255.0 - mean) / std)
    return hm, float((hm - hm_ref).abs().max())


def assert_results_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g["boxes"]) == len(r["boxes"])
        np.testing.assert_allclose(g["boxes"], r["boxes"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(g["scores"], r["scores"], atol=1e-5,
                                   rtol=0)
        for k in ("crop_keypoints", "image_keypoints"):
            assert g[k].shape == r[k].shape == (len(r["boxes"]), 17, 3)
            np.testing.assert_allclose(g[k], r[k], atol=1e-3, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_vase_engine_matches_jax(engines, kind):
    jev, pev, thr = engines
    images = batches()[kind]
    ref = jev.process_images(images, use_fused=False)
    counts = [len(r["boxes"]) for r in ref]
    assert len(set(counts)) > 1 and 0 < sum(counts), counts
    s = np.sort(np.concatenate([r["scores"] for r in ref]))
    assert np.diff(s).min() > 1e-4 and np.abs(s - thr).min() > 1e-4
    hm, hm_diff = crop_heatmaps(pev, images, ref)
    gaps, shift_diffs = peak_margins(hm)
    assert gaps.min() > 2 * hm_diff and shift_diffs.min() > 2 * hm_diff
    maxima = hm.flatten(2).amax(-1).numpy()
    assert np.abs(maxima - KPT_THR).min() > 2 * hm_diff
    assert (maxima < KPT_THR).any() and (maxima > KPT_THR).any()

    fused = pev.process_images(images)
    host = pev.process_images(images, use_fused=False)
    assert_results_close(fused, ref)
    assert_results_close(host, ref)


def test_process_images_compaction_matches_per_image(engines):
    """The fused batch gives each image what it gives it alone: boxes
    within 1e-4 px (the CPU's batched convolutions round otherwise, 2 f32
    ulps here), scores 1e-5, keypoints 1e-3."""
    _, pev, _ = engines
    images = batches()["float"]
    batched = pev.process_images(images)
    assert sum(len(r["boxes"]) for r in batched) > 0
    for i in range(B):
        single = pev.process_image(images[i])
        np.testing.assert_allclose(batched[i]["boxes"], single["boxes"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(batched[i]["scores"], single["scores"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(batched[i]["image_keypoints"],
                                   single["image_keypoints"], atol=1e-3,
                                   rtol=0)
    assert set(pev._fused_cache) >= {(B, B * MAX_DETS), (1, MAX_DETS)}


def test_quantized_bf16_engine_host_path_returns_f32_scores(workspace,
                                                            engines):
    """The quantized bf16 flavor (bf16 compute, folded trunk from the live
    checkpoint, int8 RoI pyramid): the host path brings the bf16 scores to
    the host as f32 (numpy has no bf16), the same values the fused path's
    packed f32 buffer carries; bf16 ties may order them differently, so
    each image's scores are compared sorted."""
    _, _, thr = engines
    ev = port_engine(workspace, bbox_thr=thr, dtype=torch.bfloat16,
                     trunk_quant="folded", roi_patch_quant=True)
    assert ev.detector.trunk_quant == "folded" and \
        ev.pose_model.stem1.conv.weight.dtype == torch.bfloat16
    images = batches()["uint8"]
    fused = ev.process_images(images)
    host = ev.process_images(images, use_fused=False)
    assert sum(len(r["scores"]) for r in host) > 0
    for f, h in zip(fused, host):
        assert h["scores"].dtype == f["scores"].dtype == np.float32
        np.testing.assert_array_equal(np.sort(h["scores"]),
                                      np.sort(f["scores"]))
        as_bf16 = torch.from_numpy(h["scores"]).to(torch.bfloat16).float()
        np.testing.assert_array_equal(as_bf16.numpy(), h["scores"])


def test_vase_pipeline_matches_jax(workspace):
    """get_vase_subset -> DetectionDataPipeline on cv2-written JPEGs of
    several sizes: canvases, scales, ids and counts exactly the JAX
    pipeline's, the short tail batch included."""
    ws = workspace
    kw = dict(img_size=FASTER_RCNN_TINY.image_size, dataset_name=DATASET,
              data_path=ws["data"], batch_size=2, num_workers=2)
    got, ref = list(get_vase_subset(**kw)), list(jax_vase_subset(**kw))
    assert [b["n_valid"] for b in got] == [b["n_valid"] for b in ref] == \
        [2, 2, 1]
    for g, r in zip(got, ref):
        for k in ("image", "scale", "image_id", "boxes", "box_mask"):
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    # a directory missing from the data root is read from class_arch_data
    arch = os.path.join(ws["data"], "class_arch_data", "red_black")
    write_vases(arch, 1, seed=1)
    assert [r.image for r in get_vase_subset(
        dataset_name="red_black", data_path=ws["data"]).records] == \
        [os.path.join(arch, "vase_0.jpg")]


def test_qualitative_comparison_renders_like_jax(engines, monkeypatch):
    """qualitative_comparison(limit=1, save=True): one image, the same PNG
    names as the JAX engine."""
    jev, pev, _ = engines
    for ev in (jev, pev):
        monkeypatch.setattr(ev, "save", True)
        assert ev.qualitative_comparison(limit=1) == 1
    names = sorted(os.listdir(pev.plots_path))
    assert names == sorted(os.listdir(jev.plots_path)) == \
        ["img_0000_dets.png", "img_0000_poses.png"]
    assert pev.plots_path == os.path.join(pev.exp_path, "plots",
                                          f"vases_{DATASET}")


def test_vase_cli_renders_on_the_cpu(workspace, engines, monkeypatch,
                                     capsys):
    """04's main on the CPU, tiny configs from the environment, the
    workspace's checkpoints: every image of the folder drawn."""
    ws = workspace
    _, _, thr = engines
    for k, v in (("STLPOSE_DETECTOR_CONFIG", "faster_rcnn_tiny"),
                 ("STLPOSE_MODEL_CONFIG", "tiny"), ("STLPOSE_PRETRAINED", "")):
        monkeypatch.setenv(k, v)
    for k in ("STLPOSE_DTYPE", "STLPOSE_FRCNN_TRUNK_QUANT",
              "STLPOSE_PALLAS_ROI_INT8"):
        monkeypatch.delenv(k, raising=False)
    main = importlib.import_module(
        "stlpose_tpu_torch.scripts.04_evaluate_vases_qualitatively").main
    ev = main(["-d", ws["port_exp"], "--checkpoint", "final",
               "--detector_checkpoint", "final", "--dataset_name", DATASET,
               "--data_path", ws["data"], "--bbox_thr", str(thr),
               "--limit", "3", "--device", "cpu"])
    capsys.readouterr()
    assert ev.device == torch.device("cpu") and ev.dtype == torch.float32
    assert ev.detector.config == FASTER_RCNN_TINY
    assert sorted(os.listdir(ev.plots_path)) == [
        f"img_{i:04d}_{k}.png" for i in range(3) for k in ("dets", "poses")]


def test_vase_engine_needs_a_card_unless_the_cpu_is_asked_for(
        workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = load_experiment_parameters(workspace["port_exp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VaseEvaluator(workspace["port_exp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(exp, "faster_rcnn_tiny")
    main = importlib.import_module(
        "stlpose_tpu_torch.scripts.04_evaluate_vases_qualitatively").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-d", workspace["port_exp"]])
