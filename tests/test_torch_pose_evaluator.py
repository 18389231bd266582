"""The port's evaluation engine (stlpose_tpu_torch/engines/evaluator.py)
and what it stands on: the device-warp loaders, the experiment directory
and the checkpoint files.

- Oracle AP: the ground-truth target heatmaps of the port's device-warp
  valid batches, in place of the network's output, through the port's
  decode, submission and COCO scoring, reach AP and AR > 0.95 (as
  tests/test_oracle_ap.py holds the JAX path).
- Parity: the JAX and the port ``PoseEvaluator``, both on device-warp
  batches with flip-TTA, ``config_name="tiny"``, weights from one
  reference-format ``.pth`` written from tests/torch_hrnet.py and read by
  each package's own ``load_pretrained_variables``: stats within 1e-6,
  submission keypoints within 1e-3 px. On the CPU the JAX pipeline crops
  with XLA's direct bilinear gather and the port with K4's plain two-pass
  version; unrotated, both are bilinear and differ by rounding, which
  moves the heatmaps by ~1e-6 here. Every heatmap peak and quarter-pixel
  shift decision is asserted to be more than twice that clear of a tie.
- Checkpoints: save -> load round trips in the three loading modes.
"""

import json
import os

import numpy as np
import pytest
import torch

from stlpose_tpu.config import HRNET_TINY as JAX_HRNET_TINY
from stlpose_tpu.engines import PoseEvaluator as JaxPoseEvaluator
from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.data.loaders import load_dataset
from stlpose_tpu_torch.engines.evaluator import PoseEvaluator
from stlpose_tpu_torch.eval.submission import (compute_precision,
                                               generate_submission)
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.ops.decode import decode_heatmaps
from stlpose_tpu_torch.parallel.steps import make_infer_fn
from stlpose_tpu_torch.train.optim import build_scheduler, get_current_lr
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils import checkpoint as ckpt
from stlpose_tpu_torch.utils.experiment import (create_experiment,
                                                load_experiment_parameters)
from tests.fixtures import make_coco_dataset
from tests.test_torch_eval_step import peak_margins
from tests.torch_hrnet import TorchHRNet


def _exp(root, name, **overrides):
    return create_experiment(name, {"device_warp": True, **overrides},
                             root=str(root / "experiments"))


def test_oracle_ap_on_the_device_warp_path(tmp_path, capsys):
    data = tmp_path / "data"
    make_coco_dataset(str(data), n_train=1, n_val=6, people_per_img=2,
                      img_hw=(480, 640))
    exp = load_experiment_parameters(_exp(tmp_path, "oracle", batch_size=4))
    _, pipe = load_dataset(exp, train=False, data_path=str(data),
                           num_workers=2, device="cpu")
    preds_file = str(tmp_path / "submission.json")
    all_preds, all_boxes, image_ids = [], [], []
    for batch in pipe:
        n = batch["n_valid"]
        preds, maxvals, _ = decode_heatmaps(
            batch["target"][:n], torch.from_numpy(batch["center"][:n]),
            torch.from_numpy(batch["scale"][:n]))
        all_preds.append(torch.cat([preds, maxvals[..., None]], -1).numpy())
        area = np.prod(batch["scale"][:n] * 200.0, axis=1)
        all_boxes.append(np.concatenate(
            [batch["center"][:n], batch["scale"][:n], area[:, None],
             batch["score"][:n, None]], axis=1))
        image_ids.extend(batch["image_id"][:n].tolist())
    assert len(image_ids) == 12
    generate_submission(np.concatenate(all_preds), np.concatenate(all_boxes),
                        image_ids, preds_file)
    stats = compute_precision(preds_file, os.path.join(
        str(data), "annotations", "person_keypoints_val.json"))
    capsys.readouterr()
    assert stats[0] > 0.95, stats
    assert stats[5] > 0.95, stats


def _write_pth(path):
    """A reference-format HRNet-tiny state dict with seeded weights and
    BatchNorm statistics."""
    torch.manual_seed(3)
    model = TorchHRNet(JAX_HRNET_TINY)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features,
                                               generator=g) + 0.5)
    torch.save(model.state_dict(), path)


def test_pose_evaluator_matches_jax(tmp_path, capsys):
    data = tmp_path / "data"
    make_coco_dataset(str(data), n_train=1, n_val=4)
    pth = str(tmp_path / "tiny.pth")
    _write_pth(pth)
    runs = {}
    for tag, cls, kw in (("jax", JaxPoseEvaluator, {}),
                         ("port", PoseEvaluator, {"device": "cpu"})):
        exp_path = _exp(tmp_path, tag, batch_size=8)
        ev = cls(exp_path, data_path=str(data), num_workers=2, flip=True,
                 **kw)
        ev.setup_model_dataset(config_name="tiny", pretrained=pth)
        stats = np.asarray(ev.evaluate_model())
        preds = json.load(open(ev.preds_file))
        blob = json.load(open(os.path.join(exp_path, [
            f for f in os.listdir(exp_path)
            if f.startswith("evaluation_stats")][0])))
        runs[tag] = (stats, preds, blob, ev)
    capsys.readouterr()
    (ref, ref_preds, ref_blob, _), (got, got_preds, blob, ev) = \
        runs["jax"], runs["port"]

    # the port's flip-TTA heatmaps of its own crops and of the JAX
    # pipeline's: every peak and every shift decision is more than twice
    # their difference clear of a tie
    batch = next(iter(ev.valid_pipe))
    jax_batch = next(iter(runs["jax"][3].valid_pipe))
    assert batch["n_valid"] == jax_batch["n_valid"] == 8
    infer = make_infer_fn(ev.model, decode=False)
    hm = infer(batch["image"])
    crop_diff = float((hm - infer(torch.tensor(np.asarray(
        jax_batch["image"])))).abs().max())
    gaps, shift_diffs = peak_margins(hm)
    assert 0 < crop_diff < 1e-5
    assert gaps.min() > 2 * crop_diff and shift_diffs.min() > 2 * crop_diff

    assert got.shape == ref.shape == (10,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert len(got_preds) == len(ref_preds) > 0
    for g, r in zip(got_preds, ref_preds):
        assert g["image_id"] == r["image_id"]
        np.testing.assert_allclose(np.reshape(g["keypoints"], (17, 3))[:, :2],
                                   np.reshape(r["keypoints"], (17, 3))[:, :2],
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["score"], r["score"], rtol=1e-4)
    assert list(blob) == list(ref_blob) == ["None"]
    assert ev.valid_acc == pytest.approx(runs["jax"][3].valid_acc, abs=1e-6)


def test_engine_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """The inline stylizer is refused; ``save_visualizations=True`` draws
    the first ``max_visualizations`` crops under plots/eval_examples; no
    engine without a card unless the CPU is asked for."""
    exp = load_experiment_parameters(_exp(tmp_path, "refuse"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        load_dataset({**exp, "dataset": {**exp["dataset"],
                                         "inline_style": {"style_dir": "/s"}}},
                     train=False, device="cpu")
    exp_path = _exp(tmp_path, "refuse2", batch_size=2)
    data = tmp_path / "data"
    make_coco_dataset(str(data), n_train=1, n_val=2)
    ev = PoseEvaluator(exp_path, data_path=str(data), num_workers=2,
                       save_visualizations=True, max_visualizations=3,
                       device="cpu")
    ev.setup_model_dataset(config_name="tiny", pretrained=None)
    ev.evaluate_model()
    capsys.readouterr()
    assert len(ev.valid_pipe.records) == 4
    assert sorted(os.listdir(os.path.join(exp_path, "plots",
                                          "eval_examples"))) == sorted(
        f"eval_{int(r.image_id)}_{i % 2}.png"
        for i, r in enumerate(ev.valid_pipe.records[:3]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseEvaluator(exp_path)


def test_checkpoint_round_trip(tmp_path):
    exp_path = _exp(tmp_path, "ckpt", scheduler="plateau")
    exp = load_experiment_parameters(exp_path)
    model = PoseHighResolutionNet(HRNET_TINY, device="cpu")
    state = create_train_state(model, exp)
    x = torch.randn(2, 256, 192, 3)
    model.train()
    model(x).square().mean().backward()
    state.optimizer.step()
    state.step = 7
    sched = build_scheduler(exp)
    sched.step(0.5, 1e-3)
    sched.step(0.4, 1e-3)
    ckpt.save_checkpoint(state, exp_path, 3, scheduler=sched)
    ckpt.save_checkpoint(state, exp_path, 4, finished=True)
    assert ckpt.list_checkpoints(exp_path) == ["3", "final"]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_opt = state.optimizer.state_dict()

    fresh = create_train_state(PoseHighResolutionNet(HRNET_TINY,
                                                     device="cpu"), exp)
    fresh_sched = build_scheduler(exp)
    fresh, epoch = ckpt.load_checkpoint(fresh, exp_path, 3,
                                        scheduler=fresh_sched)
    assert epoch == 3 and fresh.step == 7
    assert fresh_sched.state_dict() == sched.state_dict()
    assert get_current_lr(fresh.optimizer) == get_current_lr(state.optimizer)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    got_opt = fresh.optimizer.state_dict()["state"]
    for i, s in saved_opt["state"].items():
        for k, v in s.items():
            assert torch.equal(got_opt[i][k], v), (i, k)

    head = create_train_state(PoseHighResolutionNet(HRNET_TINY,
                                                    device="cpu"), exp)
    own_head = head.model.final_layer.weight.detach().clone()
    head, epoch = ckpt.load_checkpoint(head, exp_path, "final",
                                       only_model=True, drop_head=True)
    assert epoch == 0 and head.step == 0
    assert torch.equal(head.model.final_layer.weight, own_head)
    assert torch.equal(head.model.stem1.conv.weight,
                       saved["stem1.conv.weight"])
    assert not head.optimizer.state_dict()["state"]
    assert ckpt.load_pretrained_variables(head.model,
                                          str(tmp_path / "none.pth")) is None
