"""Serving export of the fused two-stage program
(stlpose_tpu_torch/serving/export.py::export_two_stage_server, the
program of engines/vase_evaluator.py::FusedTwoStage): artifacts written
by ``torch.export`` with a static batch, reloaded, and held against the
port's live call and the JAX package's ``build_fused_two_stage``
(``pallas_crop=False``) on the same weights (the round trips of
tests/test_serving_export.py: dict, uint8 + packed, folded trunk; and the
full int8 stack the card serves). The EfficientDet two-stage artifact is
in tests/test_torch_serving_export_detectors.py.

Bounds. Each reloaded artifact equals the port's live eager call at 0.0
(the packed one after unpacking on the host). The live f32 calls are held
to the JAX program at tests/test_torch_two_stage.py's bounds, on its
weights, images and thresholds: valid masks and image indices exact,
boxes and keypoints 1e-3 px, scores 1e-5, maxima 1e-4 relative, with its
preconditions asserted (kept scores 1e-4 apart and from the threshold,
every valid crop's heatmap peak 1e-4 clear of its runner-up). The trunk
folded into the convolutions is held to the live trunk at the JAX
package's own bound for that pair (2e-3, 1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
from stlpose_tpu.engines.vase_evaluator import \
    build_fused_two_stage as jax_build
from stlpose_tpu.models import fold_batchnorms as jax_fold
from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              hrnet_from_jax)
from stlpose_tpu_torch.serving import (export_two_stage_server,
                                       load_two_stage_server)
from stlpose_tpu_torch.serving.export import two_stage_server_model
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_hrnet import random_variables
from tests.torch_serving import (assert_close_to_jax,
                                 assert_graph_names_its_kernels,
                                 assert_same, live_outputs)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

B, MAX_DETS, BUDGET, THR = 2, 4, 6, 0.555
_ARTIFACTS = {}
FLAVORS = {
    "f32": dict(),
    "uint8_packed": dict(image_dtype="uint8", packed_output=True),
    "folded_trunk": dict(trunk_quant="folded"),
    "int8_stack": dict(dtype=torch.bfloat16, trunk_quant="int8",
                       roi_patch_quant=True, image_dtype="uint8",
                       packed_output=True),
}


@pytest.fixture(scope="module")
def case():
    """tests/test_torch_two_stage.py's weights and images (the JAX
    FASTER_RCNN_TINY and HRNET_TINY variables, their port modules) and the
    JAX program's outputs on the folded HRNet."""
    det, dv = jax_detector(0)
    pose = JaxHRNet(config=jax_hrnet_config("tiny"))
    pv = random_variables(jax.eval_shape(lambda: pose.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 192, 3)), train=False)), 1)
    images = np.random.RandomState(2).randint(0, 256, (B, 128, 128, 3),
                                              dtype=np.uint8)
    folded = JaxHRNet(config=jax_hrnet_config("tiny"), folded=True)
    run = jax.jit(jax_build(det, folded, bbox_thr=THR, max_dets=MAX_DETS,
                            budget=BUDGET, pallas_crop=False))
    return {"dv": dv, "pv": pv, "images": images,
            "ref": {k: np.asarray(v) for k, v in
                    run(dv, jax_fold(pv), jnp.asarray(images)).items()},
            "det": faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu"),
            "pose": hrnet_from_jax(pv, HRNET_TINY, device="cpu")}


def _kw(case, flavor):
    kw = dict(det_config=FASTER_RCNN_TINY, pose_config_name="tiny",
              bbox_thr=THR, max_dets=MAX_DETS, crop_budget=BUDGET,
              static_batch=B, device="cpu", **FLAVORS[flavor])
    if flavor == "int8_stack":
        kw["calib_batches"] = [case["images"].astype(np.float32) / 255.0]
    return kw


def artifact(case, flavor, tmp_path_factory):
    """(live program, loaded callable, manifest) of ``flavor``, exported
    and loaded once per module."""
    if flavor not in _ARTIFACTS:
        det = case["det"]
        kw = _kw(case, flavor)
        out = export_two_stage_server(det, case["pose"], str(
            tmp_path_factory.mktemp(flavor)), **kw)
        kw.pop("image_dtype", None)
        live, _ = two_stage_server_model(det, case["pose"], **kw)
        _ARTIFACTS[flavor] = (live, *load_two_stage_server(out,
                                                           device="cpu"))
    return _ARTIFACTS[flavor]


@pytest.mark.parametrize("flavor", ["f32", "uint8_packed"])
def test_two_stage_artifact_matches_live_and_jax(case, tmp_path_factory,
                                                 flavor):
    """The f32 dict artifact on [0, 1] images, and the uint8-ingest packed
    one on the same images' bytes (its buffer unpacked on the host with
    the manifest's layout): each equals the live call, and the live call
    holds the JAX program (which takes the bytes, as the port's does)."""
    live, serve, mf = artifact(case, flavor, tmp_path_factory)
    assert mf["pipeline"] == "two_stage" and mf["batch"] == B
    assert mf["crop_budget"] == BUDGET
    images = case["images"]
    if flavor == "f32":
        images = images.astype(np.float32) / 255.0
    else:
        assert mf["packed_output"] and \
            mf["input"]["images"][4].startswith("uint8")
    got = serve(torch.from_numpy(images))
    if flavor == "f32":
        got = {k: v.numpy() for k, v in got.items()}
    ref = live_outputs(live, images)
    assert_same(got, ref)
    assert_close_to_jax(got, case["ref"], live.pose_model
                        if flavor == "f32" else live.fused.pose_model,
                        case["images"], THR)


def test_two_stage_folded_trunk_matches_live_flavor(case, tmp_path_factory):
    """``trunk_quant="folded"`` folds the live-BatchNorm detector weights
    inside the export: the artifact equals the live folded program and
    agrees with the live-trunk program on every output."""
    live, serve, mf = artifact(case, "folded_trunk", tmp_path_factory)
    assert mf["trunk_quant"] == "folded"
    images = case["images"].astype(np.float32) / 255.0
    got = {k: v.numpy() for k, v in serve(torch.from_numpy(images)).items()}
    assert_same(got, live_outputs(live, images))
    plain = artifact(case, "f32", tmp_path_factory)[0]
    ref = live_outputs(plain, images)
    for k in ref:
        np.testing.assert_allclose(got[k].astype(np.float32), ref[k],
                                   atol=2e-3, rtol=1e-4, err_msg=k)


def test_two_stage_int8_stack(case, tmp_path_factory):
    """The full quantized stack the card serves (bf16, int8 trunk
    calibrated on the images, int8 RoI pyramid, uint8 ingest, packed
    output): the artifact equals the live call; the manifest records the
    flavor."""
    live, serve, mf = artifact(case, "int8_stack", tmp_path_factory)
    assert mf["compute_dtype"] == "bfloat16" and mf["trunk_quant"] == "int8"
    assert mf["roi_patch_quant"] and mf["packed_output"]
    got = serve(torch.from_numpy(case["images"]))
    assert_same(got, live_outputs(live, case["images"]))
    assert got["picked_valid"].any()
    assert np.isfinite(got["img_kpts"][got["picked_valid"]]).all()


@pytest.mark.parametrize("flavor, kernels", [
    ("f32", ["affine_crop", "box_nms_topk", "heatmap_peaks", "roi_align"]),
    ("uint8_packed", ["affine_crop", "box_nms_topk", "heatmap_peaks",
                      "roi_align"]),
    ("int8_stack", ["affine_crop", "box_nms_topk", "heatmap_peaks",
                    "int8_conv", "quantize_activations", "quantize_levels",
                    "roi_align"])])
def test_graph_names_the_kernels_of_its_path(case, tmp_path_factory, flavor,
                                             kernels):
    """Each two-stage artifact's graph calls the ``stlpose`` operator of
    every kernel its path reaches and no other, the manifest names the
    same, no plain version is inlined, and the program (its device
    constants included) moves whole to another device."""
    _, serve, mf = artifact(case, flavor, tmp_path_factory)
    assert_graph_names_its_kernels(serve.program, mf, kernels)
