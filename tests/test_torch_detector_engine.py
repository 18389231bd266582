"""Detector engines and scripts of the port (stlpose_tpu_torch/engines/
detector_trainer.py, scripts/02_train_faster_rcnn.py and
03_evaluate_faster_rcnn.py) on the CPU, on a miniature COCO-layout
dataset, and the torchvision state-dict loader (models/convert_detector.py)
against the JAX package's converter."""

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from stlpose_tpu.models.convert_detector import torch_fasterrcnn_to_flax
from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu_torch.config import FASTER_RCNN_TINY
from stlpose_tpu_torch.engines.detector_trainer import (
    DetectorEvaluator, DetectorTrainer, load_detector_pretrained)
from stlpose_tpu_torch.models.convert import faster_rcnn_from_jax
from stlpose_tpu_torch.models.convert_detector import \
    torch_fasterrcnn_to_port
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.train.optim import PlateauScheduler, get_current_lr
from stlpose_tpu_torch.utils.checkpoint import (list_checkpoints,
                                                load_detector_checkpoint)
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.fixtures import make_coco_dataset
from tests.test_detector_convert import _flax_to_torch_names
from tests.test_torch_hrnet import random_variables
import tests.torch_threads  # noqa: F401  (caps torch's threads)

TINY = "faster_rcnn_tiny"
OVERRIDES = {"batch_size": 2, "num_epochs": 3, "save_frequency": 1,
             "patience": 0, "learning_rate_factor": 0.5,
             "learning_rate": 1e-3}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_data")
    make_coco_dataset(str(root), n_train=4, n_val=2, img_hw=(128, 160))
    return str(root)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, data):
    """A 3-epoch DetectorTrainer run of the tiny detector on the CPU."""
    exp_path = create_experiment("det", OVERRIDES,
                                 root=str(tmp_path_factory.mktemp("exp")))
    tr = DetectorTrainer(exp_path, data_path=data, num_workers=2,
                         detector_config=TINY, device="cpu")
    tr.load_dataset()
    tr.setup_model()
    tr.training_loop()
    return exp_path, tr


def test_trainer_ap_plateau_loop(trained):
    """Validate -> train -> plateau on AP for 3 epochs, as the reference's
    engine (tests/test_detector.py's Faster R-CNN case): 3 finite train
    losses and 3 APs in the logs, checkpoints 0, 1, 2 and final, and the
    live learning rate equal to a replay of the scheduler over the APs."""
    exp_path, tr = trained
    with open(os.path.join(exp_path, "detector_logs.json")) as f:
        logs = json.load(f)
    assert len(logs["train_loss"]) == 3
    assert all(np.isfinite(v) for v in logs["train_loss"])
    assert len(logs["valid_ap"]) == 3
    assert all(-1.0 <= v <= 1.0 for v in logs["valid_ap"])
    assert set(list_checkpoints(exp_path, detector=True)) == \
        {"0", "1", "2", "final"}
    sim = PlateauScheduler(factor=0.5, patience=0)
    lr = 1e-3
    for ap in logs["valid_ap"]:
        lr = sim.step(ap, lr)
    assert get_current_lr(tr.state.optimizer) == pytest.approx(lr)
    assert tr.state.step == 3 * 2            # 4 images at B = 2, 3 epochs


def test_trainer_resumes_from_a_checkpoint(trained, data):
    """A resume from checkpoint 1 (saved after epochs 0 and 1) restores
    the step, the learning rate and the scheduler and, as the reference
    does, starts again at the checkpoint's epoch: epochs 1 and 2 run and
    append to the logs."""
    exp_path, _ = trained
    tr = DetectorTrainer(exp_path, checkpoint="1", resume_training=True,
                         data_path=data, num_workers=2,
                         detector_config=TINY, device="cpu")
    tr.load_dataset()
    tr.setup_model()
    assert tr.cur_epoch == 1 and tr.state.step == 2 * 2
    assert tr.scheduler.best is not None
    tr.training_loop()
    assert tr.state.step == 4 * 2
    with open(os.path.join(exp_path, "detector_logs.json")) as f:
        assert len(json.load(f)["valid_ap"]) == 5


@pytest.mark.parametrize("trunk_quant", ["none", "folded"])
def test_evaluator_serves_live_and_folded(trained, data, trunk_quant):
    """DetectorEvaluator on "final" with the live and the folded trunk: 12
    COCO stats, each finite or -1, and the stats JSON keyed by checkpoint;
    the live detector holds the checkpoint's weights."""
    exp_path, _ = trained
    ev = DetectorEvaluator(exp_path, checkpoint="final", data_path=data,
                           num_workers=2, detector_config=TINY,
                           trunk_quant=trunk_quant, device="cpu")
    ev.setup()
    assert ev.detector.trunk_quant == trunk_quant
    stats = ev.evaluate()
    assert len(stats) == 12 and all(np.isfinite(stats))
    assert all(s == -1.0 or 0.0 <= s <= 1.0 for s in stats)
    name = [f for f in os.listdir(exp_path)
            if f.startswith("detector_evaluation_stats")]
    assert len(name) == 1
    with open(os.path.join(exp_path, name[0])) as f:
        assert "final" in json.load(f)
    if trunk_quant == "none":
        final = load_detector_checkpoint(
            FasterRCNN(FASTER_RCNN_TINY, device="cpu"), exp_path, "final")
        want = final.state_dict()
        for k, v in ev.detector.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_scripts_main_on_cpu(tmp_path, data, monkeypatch):
    """02_train_faster_rcnn.py and 03_evaluate_faster_rcnn.py through
    their main(argv) with the reference's environment names."""
    monkeypatch.setenv("STLPOSE_DETECTOR_CONFIG", TINY)
    monkeypatch.setenv("STLPOSE_DETECTOR_PRETRAINED", "")
    exp_path = create_experiment("det_cli", {**OVERRIDES, "num_epochs": 1},
                                 root=str(tmp_path))
    train = importlib.import_module(
        "stlpose_tpu_torch.scripts.02_train_faster_rcnn")
    tr = train.main(["-d", exp_path, "--data_path", data, "--device",
                     "cpu"])
    assert tr.det_cfg is FASTER_RCNN_TINY
    assert set(list_checkpoints(exp_path, detector=True)) == {"0", "final"}
    evaluate = importlib.import_module(
        "stlpose_tpu_torch.scripts.03_evaluate_faster_rcnn")
    stats = evaluate.main(["-d", exp_path, "--checkpoint", "final",
                           "--data_path", data, "--device", "cpu"])
    assert len(stats) == 12 and all(np.isfinite(stats))


@pytest.mark.parametrize("naming", ["new", "old"])
def test_torchvision_loader_matches_jax_converter(tmp_path, naming):
    """A synthetic torchvision-layout state dict of the tiny detector
    (new or old torchvision names, with num_batches_tracked): the port's
    loader gives every tensor the JAX converter's value, carried to the
    port's names by faster_rcnn_from_jax, exactly; so does
    load_detector_pretrained from a .pth file."""
    det = JaxFasterRCNN(JAX_TINY, pallas_roi=False)
    variables = random_variables(
        jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0))), 3)
    state = _flax_to_torch_names(variables, JAX_TINY)
    if naming == "new":     # fpn.*_blocks.{i}.0.* as made; the RPN's conv
        state = {k.replace("rpn.head.conv.", "rpn.head.conv.0.0."): v
                 for k, v in state.items()}
    else:                   # fpn.*_blocks.{i}.*, rpn.head.conv.* as made
        state = {k.replace(".0.weight", ".weight").replace(".0.bias", ".bias")
                 if "_blocks." in k else k: v for k, v in state.items()}
    state["backbone.body.bn1.num_batches_tracked"] = np.asarray(3)
    ref = faster_rcnn_from_jax(
        torch_fasterrcnn_to_flax(state, roi_channels=JAX_TINY.fpn_channels),
        FASTER_RCNN_TINY, device="cpu").state_dict()
    got = torch_fasterrcnn_to_port(state, roi_channels=32)
    assert set(got) == {k for k in ref
                        if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k

    path = str(tmp_path / "frcnn.pth")
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()},
               path)
    port = FasterRCNN(FASTER_RCNN_TINY, device="cpu")
    assert load_detector_pretrained(port, path) is not None
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    assert load_detector_pretrained(port, str(tmp_path / "none.pth")) is None
