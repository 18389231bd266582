"""The whole ported slice: stlpose_tpu_torch's fused two-stage program
against stlpose_tpu's ``build_fused_two_stage`` on the same weights
(tiny detector + tiny HRNet), plus the port's structural rules: no import
of the JAX package, and entry points that default to the card."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.engines.vase_evaluator import \
    build_fused_two_stage as jax_build
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu_torch.config import (FASTER_RCNN_TINY, HRNET_TINY,
                                      IMAGENET_MEAN, IMAGENET_STD)
from stlpose_tpu_torch.engines.vase_evaluator import (
    _fused_pack_spec, _pack_fused_outputs, _unpack_fused_outputs,
    build_fused_two_stage)
from stlpose_tpu_torch.kernels import decode as _k1
from stlpose_tpu_torch.kernels import nms as _k5
from stlpose_tpu_torch.kernels import roi_align as _k3
from stlpose_tpu_torch.kernels import warp as _k2
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.ops.affine import coords_to_center_scale
from stlpose_tpu_torch.ops.nms import top_k
from stlpose_tpu_torch.ops.warp import crop_from_center_scale_batched
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import random_variables
import tests.torch_threads  # noqa: F401  (caps torch's threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, MAX_DETS, BUDGET, THR = 2, 4, 6, 0.555


def _heatmap_gaps(port_pose, images_u8, out):
    """Top-1 minus top-2 value of every heatmap of the valid crops, the
    crops rebuilt from the outputs (the program's compaction order)."""
    sel_valid = torch.from_numpy(out["sel_valid"])
    key = sel_valid.reshape(-1) * 10.0 + torch.where(
        sel_valid, torch.from_numpy(out["sel_scores"]), 0.0).reshape(-1)
    _, idx = top_k(key, BUDGET)
    boxes = torch.from_numpy(out["sel_boxes"]).reshape(-1, 4)[idx]
    c, s = coords_to_center_scale(boxes, 0.75)
    imgs = torch.from_numpy(images_u8).float() / 255.0 * 255.0
    crops = crop_from_center_scale_batched(
        imgs, c, s, torch.from_numpy(out["img_idx"]), (192, 256))
    x = (crops / 255.0 - torch.from_numpy(IMAGENET_MEAN)) / \
        torch.from_numpy(IMAGENET_STD)
    with torch.inference_mode():
        hm = port_pose(x).permute(0, 3, 1, 2).flatten(2)
    top2 = hm.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1])[torch.from_numpy(
        out["picked_valid"])]


def test_fused_two_stage_matches_jax():
    """uint8 images through both programs. sel_valid, picked_valid and
    img_idx are exact (stable top-k ties on both sides); boxes and scores
    within 1e-3 px / 1e-5 (f32 convolution order); keypoints within 1e-3
    px; maxvals within 1e-4 relative: under ``jit`` the reference's crop
    arithmetic is contracted into FMAs, so its crops of these noise images
    differ by up to ~5e-3 (0-255), ~8e-5 relative once through HRNet.
    Stable because every kept score is 1e-4 clear of its neighbours and
    of ``bbox_thr``, and every valid crop's heatmap peak is 1e-4 clear of
    its runner-up (asserted)."""
    det, dv = jax_detector(0)
    pose = JaxHRNet(config=jax_hrnet_config("tiny"))
    pv = random_variables(jax.eval_shape(lambda: pose.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 192, 3)), train=False)), 1)
    images = np.random.RandomState(2).randint(0, 256, (B, 128, 128, 3),
                                              dtype=np.uint8)
    ref_fn = jax.jit(jax_build(det, pose, bbox_thr=THR, max_dets=MAX_DETS,
                               budget=BUDGET, pallas_crop=False))
    ref = {k: np.asarray(v) for k, v in
           ref_fn(dv, pv, jnp.asarray(images)).items()}

    port_pose = hrnet_from_jax(pv, HRNET_TINY, device="cpu")
    fused = build_fused_two_stage(
        faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu"), port_pose,
        bbox_thr=THR, max_dets=MAX_DETS, budget=BUDGET, device="cpu")
    got = {k: v.numpy() for k, v in fused(images).items()}

    sv = ref["sel_valid"]
    assert 0 < ref["picked_valid"].sum() < BUDGET   # valid and padded slots
    s = np.sort(ref["sel_scores"][sv])
    assert np.diff(s).min() > 1e-4 and np.abs(s - THR).min() > 1e-4
    assert _heatmap_gaps(port_pose, images, got).min() > 1e-4

    for k in ("sel_valid", "picked_valid", "img_idx"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["sel_boxes"], ref["sel_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["sel_scores"][sv], ref["sel_scores"][sv],
                               atol=1e-5, rtol=0)
    pv_ = ref["picked_valid"]
    for k in ("crop_kpts", "img_kpts"):
        np.testing.assert_allclose(got[k][pv_][..., :2], ref[k][pv_][..., :2],
                                   atol=1e-3, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k][pv_][..., 2], ref[k][pv_][..., 2],
                                   atol=1e-5, rtol=1e-4, err_msg=k)

    # packed single-buffer output round-trips to the same dict
    spec = _fused_pack_spec(B, MAX_DETS, BUDGET)
    buf = _pack_fused_outputs({k: torch.from_numpy(v) for k, v in
                               got.items()}, spec).numpy()
    back = _unpack_fused_outputs(buf, spec)
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
    with pytest.raises(ValueError, match="layout mismatch"):
        _unpack_fused_outputs(buf[:-1], spec)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _imported_at_import_time(path):
    """Roots of the imports a module runs when it is imported: every
    import outside a function body."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0]
            yield from walk(child)
    yield from walk(ast.parse(path.read_text(), filename=str(path)))


def test_port_imports_nothing_of_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package (not even its pure-numpy modules); cv2 and matplotlib,
    which the card's machine lacks, are imported only inside the
    functions that use them."""
    files = sorted((ROOT / "stlpose_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15 and files[-1].exists()
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"stlpose_tpu_torch/{m}" for m in (
        "engines/trainer.py", "utils/arguments.py", "utils/profiling.py",
        "scripts/01_create_experiment.py", "scripts/02_train.py",
        "scripts/03_evaluate.py", "ops/bbox_utils.py", "ops/pose_entries.py",
        "utils/visualization.py", "data/detection_dataset.py",
        "engines/detector_trainer.py",
        "scripts/04_evaluate_vases_qualitatively.py", "models/vgg.py",
        "models/adain.py", "data/loaders.py", "data/pipeline.py",
        "scripts/aux_train_adain_decoder.py",
        "scripts/aux_create_offline_perceptual_loss.py",
        "scripts/aux_styled_coco_preload.py",
        "scripts/02_train_faster_rcnn.py",
        "scripts/03_evaluate_faster_rcnn.py",
        "parallel/detector_steps.py", "models/convert_detector.py",
        "retrieval/__init__.py", "retrieval/hnsw.py", "retrieval/pose_db.py",
        "retrieval/metrics.py", "engines/retrieval_db.py",
        "data/legacy_openpose.py",
        "scripts/aux_map_characters_to_narratives.py",
        "scripts/05_create_archdata_retrieval_db.py",
        "scripts/06_fit_knn_tree.py", "scripts/07_retrieval_experiments.py",
        "scripts/07_retrieval_test.py",
        "scripts/07_display_database_skeletons.py",
        "models/efficientnet.py", "models/efficientdet.py",
        "serving/__init__.py", "serving/export.py", "serving/packing.py",
        "kernels/_ops.py", "scripts/08_export_serving.py")} <= names
    assert (ROOT / "stlpose_tpu_torch" / "native" / "hnsw.cpp").exists()
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "stlpose_tpu"}
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & banned)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
    host_only = {"cv2", "matplotlib"}
    at_import = {str(f.relative_to(ROOT)): sorted(
        set(_imported_at_import_time(f)) & host_only) for f in files}
    assert not {k: v for k, v in at_import.items() if v}
    inside = {str(f.relative_to(ROOT)) for f in files
              if set(_imported_roots(f)) & host_only}
    assert {f"stlpose_tpu_torch/{m}" for m in (
        "utils/visualization.py", "data/detection_dataset.py",
        "models/adain.py", "scripts/aux_train_adain_decoder.py",
        "scripts/aux_create_offline_perceptual_loss.py",
        "scripts/aux_styled_coco_preload.py",
        "scripts/07_retrieval_test.py",
        "scripts/07_display_database_skeletons.py")} <= inside


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """A wrapper runs its plain version for CPU tensors only: a tensor on
    any other device goes to the kernel's checks, never to the plain
    version (here a meta tensor, which the checks refuse)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        _k1.heatmap_peaks(torch.empty((2, 17, 64, 48), device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        _k2.affine_crop(torch.empty((2, 40, 40, 3), device=meta),
                        torch.empty((3, 4), device=meta),
                        torch.empty(3, dtype=torch.int32, device=meta),
                        (192, 256))
    with pytest.raises(ValueError, match="CUDA"):
        _k3.roi_align([torch.empty((1, 8, 8, 4), device=meta)],
                      torch.empty((1, 5, 4), device=meta),
                      torch.empty((1, 5), dtype=torch.int32, device=meta),
                      (4,))
    with pytest.raises(ValueError, match="CUDA"):
        _k5.box_nms_topk(torch.empty((2, 7, 4), device=meta),
                         torch.empty((2, 7), device=meta), 0.5,
                         torch.empty((2, 7), dtype=torch.bool, device=meta),
                         3)
    assert _k1.LAUNCHES == _k2.LAUNCHES == _k3.LAUNCHES == _k5.LAUNCHES == 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point runs on "cuda" unless told otherwise, and raises
    where there is no GPU instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FasterRCNN(FASTER_RCNN_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseHighResolutionNet(HRNET_TINY)
    det = FasterRCNN(FASTER_RCNN_TINY, device="cpu")
    pose = PoseHighResolutionNet(HRNET_TINY, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fused_two_stage(det, pose, bbox_thr=0.5, max_dets=2, budget=2)
    with pytest.raises(ValueError, match="is on cpu"):
        build_fused_two_stage(det, pose, bbox_thr=0.5, max_dets=2, budget=2,
                              device="meta")
