"""Serving export of the detectors (stlpose_tpu_torch/serving/export.py::
export_detector_server) and of the EfficientDet two-stage program, and
script 08's detector paths: artifacts written by ``torch.export``,
reloaded, and held against the port's live call and the JAX package's
live functions on the same weights (the round trips of
tests/test_serving_export.py: both detector families, uint8 ingest, the
EfficientDet two-stage program).

Bounds. Each reloaded artifact equals the port's live eager call at 0.0.
The live call holds the JAX ``predict`` as tests/test_torch_faster_rcnn.py
and tests/test_torch_efficientdet.py hold it (valid and labels exact,
scores 1e-5, boxes 1e-3 px, with their preconditions on the same weights
and images), and the JAX ``build_fused_two_stage`` at
tests/test_torch_two_stage.py's bounds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.engines.vase_evaluator import \
    build_fused_two_stage as jax_build
from stlpose_tpu.models import efficientdet as jed
from stlpose_tpu.models import fold_batchnorms as jax_fold
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax)
from stlpose_tpu_torch.serving import (export_detector_server,
                                       export_two_stage_server,
                                       load_pose_server,
                                       load_two_stage_server)
from stlpose_tpu_torch.serving.export import (DetectorServer,
                                              detector_server_model,
                                              two_stage_server_model)
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.test_torch_efficientdet import (assert_predict_close, images,
                                           serving_case)
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import random_variables
from tests.test_torch_two_stage import BUDGET
from tests.torch_serving import (assert_close_to_jax,
                                 assert_graph_names_its_kernels,
                                 assert_same, live_outputs)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B, MAX_DETS = 2, 4
_ARTIFACTS = {}


@pytest.fixture(scope="module")
def weights():
    """The JAX FASTER_RCNN_TINY (tests/test_torch_faster_rcnn.py), the
    calibrated EfficientDet of tests/test_torch_efficientdet.py and the
    HRNET_TINY of tests/test_torch_two_stage.py, with their port
    modules."""
    det, dv = jax_detector(0)
    pose = JaxHRNet(config=jax_hrnet_config("tiny"))
    pv = random_variables(jax.eval_shape(lambda: pose.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 192, 3)), train=False)), 1)
    return {"faster_rcnn": (det, dv, faster_rcnn_from_jax(
                dv, FASTER_RCNN_TINY, device="cpu")),
            "efficientdet": serving_case(jed.EFFICIENTDET_TINY, 5, 0.7),
            "pv": pv, "pose": hrnet_from_jax(pv, HRNET_TINY, device="cpu")}


def artifact(weights, kind, tmp_path_factory):
    """(live program, loaded callable, manifest) of ``kind``, exported and
    loaded once per module."""
    if kind in _ARTIFACTS:
        return _ARTIFACTS[kind]
    out = str(tmp_path_factory.mktemp(kind))
    if kind == "two_stage_efficientdet":
        port = weights["efficientdet"][2]
        kw = dict(family="efficientdet", det_config=port.config,
                  pose_config_name="tiny", bbox_thr=0.0, max_dets=MAX_DETS,
                  crop_budget=BUDGET, static_batch=B, device="cpu")
        export_two_stage_server(port, weights["pose"], out, **kw)
        live = two_stage_server_model(port, weights["pose"], **kw)[0]
        _ARTIFACTS[kind] = (live, *load_two_stage_server(out, device="cpu"))
        return _ARTIFACTS[kind]
    family = kind.split("_", 1)[1]
    port = weights[family][2]
    # Faster R-CNN takes uint8 images, EfficientDet float32 ones
    export_detector_server(port, out, family=family, config=port.config,
                           device="cpu", image_dtype="uint8"
                           if family == "faster_rcnn" else "float32")
    live = DetectorServer(detector_server_model(port, family, port.config,
                                                "cpu"))
    _ARTIFACTS[kind] = (live, *load_pose_server(out, device="cpu"))
    return _ARTIFACTS[kind]


def _separated_frcnn(ref):
    """tests/test_torch_faster_rcnn.py's preconditions: real detections,
    kept scores 1e-4 apart and from the score threshold."""
    v = ref["valid"]
    assert v.sum() >= 8
    for b in range(v.shape[0]):
        s = np.sort(ref["scores"][b][v[b]])
        assert np.diff(s).min() > 1e-4
        assert s.min() - FASTER_RCNN_TINY.score_thresh > 1e-4


@pytest.mark.parametrize("family", ["faster_rcnn", "efficientdet"])
def test_detector_artifacts(weights, tmp_path_factory, family):
    """Both families with a symbolic batch, reloaded at batches 3 and 2:
    Faster R-CNN with uint8 ingest, EfficientDet from float32 images. Each
    equals the live call (the uint8 artifact also the live call on the
    same images made [0, 1] on the host); the live call holds the JAX
    ``predict`` at its test's bounds, on that test's images."""
    live, serve, mf = artifact(weights, f"detector_{family}",
                               tmp_path_factory)
    assert mf["family"] == family and mf["batch"] == "b"
    jdet, v, _ = weights[family]
    if family == "faster_rcnn":
        assert mf["input"]["images"][4].startswith("uint8")
        rng = np.random.RandomState(1)
        batches = [rng.randint(0, 256, (n, 128, 128, 3)).astype(np.uint8)
                   for n in (3, 2)]
        x01 = np.random.RandomState(1).rand(2, 128, 128, 3).astype(
            np.float32)
    else:
        batches = [images(2, 3), images(1)]
        x01 = images(1)
    for x in batches:
        got = serve(torch.from_numpy(x))
        with torch.inference_mode():
            assert_same(got, live(torch.from_numpy(x)))
            if x.dtype == np.uint8:
                assert_same(got, live(torch.from_numpy(
                    x.astype(np.float32) / 255.0)))
    with torch.inference_mode():
        got = live(torch.from_numpy(x01))
    want = {k: np.asarray(a) for k, a in
            jax.jit(jdet.predict)(v, jnp.asarray(x01)).items()}
    if family == "faster_rcnn":
        _separated_frcnn(want)
    assert_predict_close(got, want)


def test_two_stage_efficientdet(weights, tmp_path_factory):
    """The EfficientDet family in the fused program: the artifact equals
    the live call, which holds the JAX program on the same weights at
    tests/test_torch_two_stage.py's bounds, the heatmap maxima aside: the
    f32 EfficientDet's boxes sit up to 1e-3 px from the reference's (its
    own test's bound), which moves the crops and the maxima by up to
    5e-4 relative (measured), past the 1e-4 that the Faster R-CNN program
    holds with its closer boxes; the same post-detector program's maxima
    are held there."""
    jdet, v, _ = weights["efficientdet"]
    live, serve, mf = artifact(weights, "two_stage_efficientdet",
                               tmp_path_factory)
    assert mf["family"] == "efficientdet" and mf["crop_budget"] == BUDGET
    x = np.random.RandomState(3).randint(0, 256, (B, 128, 128, 3),
                                         dtype=np.uint8)
    x01 = x.astype(np.float32) / 255.0      # the artifact takes float32
    got = {k: t.numpy() for k, t in serve(torch.from_numpy(x01)).items()}
    assert_same(got, live_outputs(live, x01))
    assert got["crop_kpts"].shape == (BUDGET, 17, 3)
    pose = JaxHRNet(config=jax_hrnet_config("tiny"), folded=True)
    ref = {k: np.asarray(a) for k, a in jax.jit(jax_build(
        jdet, pose, bbox_thr=0.0, max_dets=MAX_DETS, budget=BUDGET,
        pallas_crop=False))(v, jax_fold(weights["pv"]),
                            jnp.asarray(x)).items()}
    assert_close_to_jax(got, ref, live.pose_model, x, 0.0, maxima=False)


@pytest.mark.parametrize("kind, kernels", [
    ("detector_faster_rcnn", ["box_nms_topk", "roi_align"]),
    ("detector_efficientdet", ["box_nms_topk"]),
    ("two_stage_efficientdet", ["affine_crop", "box_nms_topk",
                                "heatmap_peaks"])])
def test_graph_names_the_kernels_of_its_path(weights, tmp_path_factory, kind,
                                             kernels):
    """Each artifact's graph calls the ``stlpose`` operator of every
    kernel its path reaches and no other, the manifest names the same, no
    plain version is inlined, and the program moves whole to another
    device."""
    _, serve, mf = artifact(weights, kind, tmp_path_factory)
    assert_graph_names_its_kernels(serve.program, mf, kernels)


def test_script_08_exports_the_two_stage_program(tmp_path, monkeypatch):
    """01 -> 08 ``--pipeline two_stage --trunk_quant folded --packed
    --image_dtype uint8 --device cpu`` with FASTER_RCNN_TINY and
    HRNET_TINY (both from the experiment's seed) -> ``load_two_stage_server``:
    the manifest records the flavor, the unpacked outputs are finite and
    shaped as the manifest says."""
    monkeypatch.setenv("STLPOSE_MODEL_CONFIG", "tiny")
    monkeypatch.setenv("STLPOSE_PRETRAINED", "")
    monkeypatch.setenv("STLPOSE_DETECTOR_CONFIG", "faster_rcnn_tiny")
    exp = create_experiment("serve", root=str(tmp_path))
    script = importlib.import_module(
        "stlpose_tpu_torch.scripts.08_export_serving")
    out = script.main(["-d", exp, "--pipeline", "two_stage",
                       "--trunk_quant", "folded", "--packed",
                       "--image_dtype", "uint8", "--batch", "2",
                       "--max_dets", "3", "--bbox_thr", "0",
                       "--out", str(tmp_path / "art"), "--device", "cpu"])
    serve, mf = load_two_stage_server(out, device="cpu")
    assert mf["trunk_quant"] == "folded" and mf["packed_output"]
    assert mf["kernels"] == ["affine_crop", "box_nms_topk", "heatmap_peaks",
                             "roi_align"]
    x = np.random.RandomState(0).randint(0, 256, (2, 128, 128, 3),
                                         dtype=np.uint8)
    got = serve(torch.from_numpy(x))
    for e in mf["output"]:
        assert got[e["key"]].shape == tuple(e["shape"]), e
    assert np.isfinite(got["img_kpts"]).all()
