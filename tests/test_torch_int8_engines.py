"""The int8 trunk in the port's engines and scripts on the CPU:
``DetectorEvaluator`` (03_evaluate_faster_rcnn.py) calibrating on its
first validation batch and ``VaseEvaluator`` (04) on its first vase
batch, both from the live template (seeded weights, then the
checkpoint's), against the JAX package's ``apply_trunk_flavor_variables``
on the same batch: ``kernel_i8`` and ``sw`` equal, every scale and bias
within 1e-6 relative (two backends' calibration sums). The int8 models
themselves are held to the JAX package in tests/test_torch_int8_models.py.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.quantize import apply_trunk_flavor_variables
from stlpose_tpu_torch.config import FASTER_RCNN_TINY
from stlpose_tpu_torch.engines.detector_trainer import (DetectorEvaluator,
                                                        apply_trunk_flavor)
from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator
from stlpose_tpu_torch.models.convert import (faster_rcnn_from_jax,
                                              jax_variables_to_state_dict)
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (load_detector_checkpoint,
                                                save_checkpoint)
from stlpose_tpu_torch.utils.experiment import (create_experiment,
                                                load_experiment_parameters)
from tests.fixtures import make_coco_dataset
from tests.test_torch_faster_rcnn import jax_detector
from tests.test_torch_vase_evaluator import (DATASET, save_port_checkpoints,
                                             write_vases)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

TINY = "faster_rcnn_tiny"
REL = 1e-6


def assert_matches_jax_trunk(sd, dv, quant, calib):
    """The port's int8 detector state dict ``sd`` against the JAX
    package's flavor of the same live variables ``dv`` on ``calib``."""
    ref = jax_variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, apply_trunk_flavor_variables(
            JAX_TINY, dv, quant, calib_batches=[np.asarray(calib)])))
    got = {k: v.cpu() for k, v in sd.items()}
    assert set(got) == set(ref)
    n_i8 = 0
    for k, r in ref.items():
        if k.endswith(("kernel_i8", ".sw")):
            n_i8 += k.endswith("kernel_i8")
            assert torch.equal(got[k], r), k
        else:
            g, r = got[k].double().numpy(), r.double().numpy()
            assert np.abs(g - r).max() <= REL * max(np.abs(r).max(), 1e-30), k
    assert n_i8 == 16


@pytest.fixture(scope="module")
def det_workspace(tmp_path_factory):
    """A miniature COCO-layout dataset and an experiment whose detector
    checkpoint "final" holds the JAX tiny detector's live weights."""
    root = tmp_path_factory.mktemp("int8_det")
    data = str(root / "data")
    make_coco_dataset(data, n_train=2, n_val=3, img_hw=(128, 160))
    exp = create_experiment("int8", {"batch_size": 2},
                            root=str(root / "exp"))
    _, dv = jax_detector(17)
    det = faster_rcnn_from_jax(dv, FASTER_RCNN_TINY, device="cpu")
    save_checkpoint(create_train_state(det, load_experiment_parameters(exp)),
                    exp, "final", detector=True)
    return {"data": data, "exp": exp, "dv": dv}


@pytest.mark.parametrize("quant", ["int8", "int8u"])
def test_detector_evaluator_int8(det_workspace, quant):
    """DetectorEvaluator with an int8 trunk: the checkpoint's weights
    quantized on the first validation batch as the JAX package quantizes
    them; 12 COCO stats, each finite or -1."""
    ws = det_workspace
    ev = DetectorEvaluator(ws["exp"], checkpoint="final",
                           data_path=ws["data"], num_workers=1,
                           detector_config=TINY, trunk_quant=quant,
                           device="cpu")
    ev.setup()
    assert ev.detector.trunk_quant == quant
    first = next(iter(ev.pipe))["image"]
    assert_matches_jax_trunk(ev.detector.state_dict(), ws["dv"], quant,
                             first)
    stats = ev.evaluate(save_stats=False)
    assert len(stats) == 12 and all(np.isfinite(stats))
    assert all(s == -1.0 or 0.0 <= s <= 1.0 for s in stats)


def test_apply_trunk_flavor_needs_a_batch_for_int8(det_workspace):
    """The engines' ``apply_trunk_flavor``: int8 without a calibration
    batch raises the JAX package's ValueError; the live trunk passes the
    state dict through; the checkpoint loader refuses an int8 detector
    (it has no calibration images)."""
    det = FasterRCNN(FASTER_RCNN_TINY, device="cpu", trunk_quant="int8")
    live = FasterRCNN(FASTER_RCNN_TINY, device="cpu")
    sd = live.state_dict()
    with pytest.raises(ValueError, match="requires calibration images"):
        apply_trunk_flavor(det, FASTER_RCNN_TINY, sd)
    assert apply_trunk_flavor(live, FASTER_RCNN_TINY, sd) is sd
    with pytest.raises(ValueError, match="requires calibration images"):
        load_detector_checkpoint(det, det_workspace["exp"], "final")


@pytest.fixture(scope="module")
def vase_workspace(tmp_path_factory):
    """Vase images and an experiment with the JAX tiny detector's and a
    tiny HRNet's weights as its checkpoints "final"."""
    from tests.test_torch_hrnet import jax_hrnet
    root = tmp_path_factory.mktemp("int8_vase")
    data = str(root / "data")
    write_vases(f"{data}/{DATASET}", 4, seed=3)
    exp = create_experiment("int8_vase", {"batch_size": 2},
                            root=str(root / "exp"))
    _, dv = jax_detector(18)
    _, pv = jax_hrnet("tiny", 19)
    save_port_checkpoints(exp, dv, pv)
    return {"data": data, "exp": exp, "dv": dv}


def vase_engine(ws, **kw):
    ev = VaseEvaluator(ws["exp"], checkpoint="final",
                       detector_checkpoint="final", dataset_name=DATASET,
                       data_path=ws["data"], max_dets=4, bbox_thr=0.0,
                       detector_config=TINY, save=False, device="cpu",
                       trunk_quant="int8", **kw)
    ev.load_vase_subset(batch_size=2)
    return ev


def test_vase_evaluator_int8(vase_workspace):
    """VaseEvaluator with STLPOSE_FRCNN_TRUNK_QUANT=int8's flavor: the
    detector checkpoint quantized on the first vase batch as the JAX
    package quantizes it; its fused program equal to its host path
    (boxes 1e-4, scores 1e-5, keypoints 1e-3, the JAX package's
    tolerances)."""
    ws = vase_workspace
    ev = vase_engine(ws)
    ev.setup_models(config_name="tiny")
    first = next(iter(ev.pipe))["image"]
    assert_matches_jax_trunk(ev.detector.state_dict(), ws["dv"], "int8",
                             first)
    fused = ev.process_images(first)
    host = ev.process_images(first, use_fused=False)
    assert sum(len(r["boxes"]) for r in host) > 0
    for f, h in zip(fused, host):
        np.testing.assert_allclose(f["boxes"], h["boxes"], atol=1e-4)
        np.testing.assert_allclose(f["scores"], h["scores"], atol=1e-5)
        np.testing.assert_allclose(f["image_keypoints"],
                                   h["image_keypoints"], atol=1e-3)
    assert ev.qualitative_comparison() == 4


def test_vase_evaluator_int8_without_a_subset_raises(vase_workspace):
    """Without the vase subset to calibrate on, setup_models raises the
    JAX engine's message."""
    ev = vase_engine(vase_workspace)
    ev.pipe = None
    with pytest.raises(RuntimeError, match="calibrates on the first image"):
        ev.setup_models(config_name="tiny")


def test_03_with_an_int8u_trunk(det_workspace, monkeypatch):
    """03_evaluate_faster_rcnn.py's main with
    STLPOSE_FRCNN_TRUNK_QUANT=int8u: the engine serves the int8u trunk
    and writes 12 stats, each finite or -1."""
    ws = det_workspace
    monkeypatch.setenv("STLPOSE_DETECTOR_CONFIG", TINY)
    monkeypatch.setenv("STLPOSE_FRCNN_TRUNK_QUANT", "int8u")
    built = []
    setup = DetectorEvaluator.setup

    def recorded(self):
        setup(self)
        built.append(self.detector.trunk_quant)

    monkeypatch.setattr(DetectorEvaluator, "setup", recorded)
    script = importlib.import_module(
        "stlpose_tpu_torch.scripts.03_evaluate_faster_rcnn")
    stats = script.main(["-d", ws["exp"], "--checkpoint", "final",
                         "--data_path", ws["data"], "--device", "cpu"])
    assert built == ["int8u"]
    assert len(stats) == 12 and all(s == -1.0 or 0.0 <= s <= 1.0
                                    for s in stats)
