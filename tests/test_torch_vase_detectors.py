"""The detector factory behind the port's vase engine
(stlpose_tpu_torch/engines/detector_trainer.py::build_detector, both
families) against the JAX package's, the detector checkpoints (live and
folded) of the workspace of tests/test_torch_vase_evaluator.py, and the
vase engine serving EfficientDet on the CPU. Split from that file so that
each test file of the port holds at most 12 tests (pytest-xdist's
``--dist loadfile`` queues files largest first).
"""

import dataclasses

import numpy as np
import pytest
import torch

from stlpose_tpu.engines import detector_trainer as jax_detector_trainer
from stlpose_tpu.models import efficientdet as jed
from stlpose_tpu_torch.config import FASTER_RCNN_TINY
from stlpose_tpu_torch.engines.detector_trainer import (DETECTOR_CONFIGS,
                                                        build_detector)
from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator
from stlpose_tpu_torch.models.convert import faster_rcnn_from_jax
from stlpose_tpu_torch.models.efficientdet import EfficientDet
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.utils.checkpoint import load_detector_checkpoint
from stlpose_tpu_torch.utils.experiment import load_experiment_parameters
from tests.test_torch_efficientdet import serving_case
from tests.test_torch_vase_evaluator import (B, DATASET, KPT_THR, MAX_DETS,
                                             assert_results_close, batches,
                                             workspace)
import tests.torch_threads  # noqa: F401  (caps torch's threads)


@pytest.mark.parametrize("name", ["faster_rcnn", "faster_rcnn_tiny",
                                  "faster_rcnn_torchvision_parity"])
def test_build_detector_configs_match_jax(workspace, name):
    """The port's detector config has the JAX one's fields, the training
    budgets and sampling included, each equal."""
    exp = load_experiment_parameters(workspace["port_exp"])
    exp["model"]["detector_name"] = name
    _, ref = jax_detector_trainer.build_detector(exp)
    got = DETECTOR_CONFIGS[name]
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    if name == "faster_rcnn_tiny":
        det, cfg = build_detector(exp, device="cpu")
        assert cfg is got and isinstance(det, FasterRCNN) and \
            det.config is got and det.trunk_quant == "none"


@pytest.mark.parametrize("name, det_type", [
    ("efficientdet", ""), ("efficientdet", "d3"), ("efficientdet_d0", ""),
    ("efficientdet_tiny", "")])
def test_build_detector_refuses_efficientdet(workspace, name, det_type):
    """build_detector refuses, for each EfficientDet name, the Faster
    R-CNN-only flavors (``trunk_quant``, ``roi_patch_quant``), and, for
    any family, an unknown name. That each name builds is
    tests/test_torch_efficientdet_train.py's
    test_build_detector_builds_efficientdet."""
    exp = load_experiment_parameters(workspace["port_exp"])
    exp["model"].update(detector_name=name, detector_type=det_type)
    for flavor in ({"trunk_quant": "folded"}, {"roi_patch_quant": True}):
        with pytest.raises(ValueError, match="Faster R-CNN flavors"):
            build_detector(exp, device="cpu", **flavor)
    with pytest.raises(ValueError, match="not supported"):
        build_detector(exp, "yolo", device="cpu")


@pytest.mark.parametrize("trunk_quant", ["none", "folded"])
def test_detector_checkpoint_loads_live_and_folded(workspace, trunk_quant):
    """The live-BatchNorm checkpoint of the workspace loads weights-only
    into a live detector (every entry equal) and into a folded one (FPN
    maps and detections within 5e-5 relative of the live detector's)."""
    ws = workspace
    live = faster_rcnn_from_jax(ws["dv"], FASTER_RCNN_TINY, device="cpu")
    det = FasterRCNN(FASTER_RCNN_TINY, device="cpu", trunk_quant=trunk_quant)
    assert load_detector_checkpoint(det, ws["port_exp"], "final") is det
    if trunk_quant == "none":
        ref = live.state_dict()
        for k, v in det.state_dict().items():
            assert torch.equal(v, ref[k]), k
        return
    x = torch.from_numpy(batches()["float"])
    with torch.inference_mode():
        for a, b in zip(det.features(x.permute(0, 3, 1, 2)),
                        live.features(x.permute(0, 3, 1, 2))):
            assert float((a - b).abs().max() / b.abs().max()) < 5e-5
        got, ref = det.predict(x), live.predict(x)
    assert torch.equal(got["valid"], ref["valid"])
    v = ref["valid"]
    assert float((got["boxes"][v] - ref["boxes"][v]).abs().max()) < \
        5e-5 * float(ref["boxes"][v].abs().max())


def test_vase_engine_serves_efficientdet(workspace):
    """VaseEvaluator on EFFICIENTDET_TINY (the seeded, calibrated weights
    of tests/test_torch_efficientdet.py) and the workspace's HRNet
    checkpoint:
    the fused path equals the host path (boxes 1e-4, scores 1e-5,
    keypoints 1e-3, the JAX package's fused-vs-host tolerances), at a
    bbox_thr between two person scores where the per-image counts vary;
    both batch shapes' programs are cached."""
    ws = workspace
    ev = VaseEvaluator(ws["port_exp"], checkpoint="final",
                       dataset_name=DATASET, data_path=ws["data"],
                       max_dets=MAX_DETS, kpt_thr=KPT_THR,
                       detector_config="efficientdet_tiny", save=False,
                       device="cpu")
    ev.load_vase_subset()
    ev.setup_models(config_name="tiny")
    assert isinstance(ev.detector, EfficientDet)
    assert ev.det_cfg.image_size == FASTER_RCNN_TINY.image_size
    # seeded weights that keep the images' signal (PyTorch's default
    # initialisation scores every anchor within 1e-3 of the prior)
    ev.detector.load_state_dict(
        serving_case(jed.EFFICIENTDET_TINY, 5, 1.5)[2].state_dict())
    images = batches()["float"]
    dets = ev.detector.predict(torch.from_numpy(images))
    scores = np.where(dets["valid"].numpy(), dets["scores"].numpy(), -1.0)
    s = np.sort(scores[scores > 0])[::-1]
    # the highest threshold between two scores that gives the images
    # different counts (at most MAX_DETS each)
    ev.bbox_thr = next(
        t for t in (s[:-1] + s[1:]) / 2
        if len({min(int((row > t).sum()), MAX_DETS)
                for row in scores}) > 1)
    host = ev.process_images(images, use_fused=False)
    counts = [len(r["boxes"]) for r in host]
    assert len(set(counts)) > 1 and sum(counts) > 0, counts
    assert_results_close(ev.process_images(images), host)
    assert_results_close(ev.process_images(images[:1]), host[:1])
    assert set(ev._fused_cache) == {(B, B * MAX_DETS), (1, MAX_DETS)}
