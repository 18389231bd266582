"""The port's engines on a data-parallel mesh of two gloo ranks against
the same engines in one process (stlpose_tpu_torch/engines/ with the
process group up, parallel/mesh.py::get_mesh).

``engine_runs`` drives every engine of the module on tiny configs with
the experiment seed's weights: the pose trainer (one epoch), the pose
evaluator, the detector trainer (one epoch, both families) and its
evaluation, the
retrieval-database extractor and the vase engine (the host path, and the
fused program, sharded on the mesh). One launch of two rank processes
runs it (tests/torch_ranks.py), and this process runs it once more with
no process group; the tests compare the two. Batches are sized so that
the last one of the evaluators is padded to the mesh and the padding
dropped.

Bounds: the trainers' logged losses within 1e-4 relative (the one-rank
statistics are ``F.batch_norm``'s, the two-rank ones summed over the
group in f64), accuracies and AP equal, the parameters after SGD within
1e-4 of each tensor's largest magnitude (Adam's lr*sign(g) first update
would turn the rounding of a gradient near zero into an O(lr) move);
keypoints within 1e-3 px and their scores within 1e-5; the evaluators'
stats within 1e-6; the vase engine's boxes within 1e-4 px, its
keypoints as above.
"""

import json
import os

import numpy as np
import pytest
import torch

from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.fixtures import make_archdata_dataset, make_coco_dataset
from tests.torch_ranks import launch, results
import tests.torch_threads  # noqa: F401  (caps torch's threads)

VASES, MAX_DETS, VASE_B = "ccoimages_final", 4, 3
POSE_TRAIN = {"batch_size": 4, "num_epochs": 1, "save_frequency": 1,
              "optimizer": "sgd", "learning_rate": 1e-3, "scale_factor": 0.25,
              "rot_factor": 30, "flip": True, "device_warp": True}
DETECTORS = ("faster_rcnn_tiny", "efficientdet_tiny")
DET_TRAIN = {"batch_size": 2, "num_epochs": 1, "save_frequency": 1,
             "optimizer": "sgd", "learning_rate": 1e-3}

_BODY = """
from tests.test_torch_sharded_engines import engine_runs
save(engine_runs(os.path.dirname(out), "two"))
"""


def _write_vases(d, n, seed=0):
    import cv2
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        hw = (rng.randint(200, 300), rng.randint(240, 320), 3)
        cv2.imwrite(os.path.join(d, f"vase_{i}.jpg"),
                    rng.randint(0, 255, hw, np.uint8))


def engine_runs(ws, tag):
    """Every engine once on ``device="cpu"``, in experiments named
    ``<tag>_*`` under ``ws``; returns what the tests compare."""
    from stlpose_tpu_torch.config import FASTER_RCNN_TINY
    from stlpose_tpu_torch.engines.detector_trainer import (
        DetectorEvaluator, DetectorTrainer)
    from stlpose_tpu_torch.engines.evaluator import PoseEvaluator
    from stlpose_tpu_torch.engines.retrieval_db import ArchDataExtractor
    from stlpose_tpu_torch.engines.trainer import PoseTrainer
    from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator
    from stlpose_tpu_torch.parallel.distributed import process_index

    with open(os.path.join(ws, "cfg.json")) as f:
        cfg = json.load(f)
    exps = cfg["experiments"][tag]
    out = {"rank": process_index()}

    def params(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    exp = exps["pose"]
    tr = PoseTrainer(exp, data_path=cfg["pose_data"], num_workers=1,
                     make_plots=False, device="cpu")
    tr.load_dataset()
    tr.setup_model(config_name="tiny", pretrained=None)
    tr.training_loop()
    out["trainer"] = {"mesh": tr.mesh.size(), "params": params(tr.model),
                      "files": sorted(os.listdir(os.path.join(exp,
                                                              "models")))}

    ev = PoseEvaluator(exp, checkpoint="final", data_path=cfg["pose_data"],
                       num_workers=1, device="cpu")
    ev.exp_data["training"]["batch_size"] = 3   # a padded last batch
    ev.setup_model_dataset(config_name="tiny", pretrained=None)
    out["evaluator"] = {"stats": np.asarray(ev.evaluate_model()),
                        "loss": ev.valid_loss, "acc": ev.valid_acc}
    with open(ev.preds_file) as f:
        out["evaluator"]["preds"] = json.load(f)

    for name in DETECTORS:
        exp = exps[name]
        dt = DetectorTrainer(exp, data_path=cfg["det_data"], num_workers=1,
                             detector_config=name, device="cpu")
        dt.load_dataset()
        dt.setup_model()
        dt.training_loop()
        de = DetectorEvaluator(exp, checkpoint="final",
                               data_path=cfg["det_data"], num_workers=1,
                               detector_config=name, device="cpu")
        de.setup()
        out[name] = {"params": params(dt.detector),
                     "stats": de.evaluate(save_stats=False)}
        with open(os.path.join(exp, "detector_logs.json")) as f:
            out[name]["logs"] = json.load(f)

    ex = ArchDataExtractor(exps["arch"], dataset_name="arch_data",
                           data_path=cfg["arch_data"], num_workers=1,
                           device="cpu")
    ex.setup(config_name="tiny")
    ex.extract_retrieval_dataset()
    path = ex.save_retrieval_db(root=os.path.join(ws, f"{tag}_dbs"))
    out["extractor"] = {"db": ex.retrieval_db, "path": path,
                        "written": os.path.exists(path)}

    ve = VaseEvaluator(exps["vase"], dataset_name=VASES,
                       data_path=cfg["det_data"], max_dets=MAX_DETS,
                       detector_config="faster_rcnn_tiny", save=False,
                       device="cpu")
    ve.load_vase_subset(batch_size=VASE_B)
    ve.setup_models(config_name="tiny")
    rng = np.random.RandomState(12)
    S = FASTER_RCNN_TINY.image_size
    images = rng.rand(4, S, S, 3).astype(np.float32)
    # a score threshold at the median person score of the first 3 images
    # (the detector run whole on every rank), so that their detection
    # counts differ
    with torch.inference_mode():
        dets = ve.detector.predict(torch.from_numpy(images[:3]))
    person = dets["valid"] & (dets["labels"] == 1)
    ve.bbox_thr = float(dets["scores"][person].median())
    out["vase"] = {"host": ve.process_images(images[:3], use_fused=False),
                   "default": ve.process_images(images[:3]),
                   "fused": ve.process_images(images, use_fused=True),
                   "n_done": ve.qualitative_comparison()}
    try:
        ve.process_images(images[:3], use_fused=True)
        out["vase"]["ragged_fused"] = "ran"
    except ValueError as e:
        out["vase"]["ragged_fused"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process results, [rank 0's, rank 1's], workspace)."""
    ws = tmp_path_factory.mktemp("sharded_engines")
    cfg = {"pose_data": str(ws / "pose_data"), "det_data": str(ws / "det"),
           "arch_data": str(ws / "arch_data")}
    make_coco_dataset(cfg["pose_data"], n_train=4, n_val=6)
    make_coco_dataset(cfg["det_data"], n_train=4, n_val=3,
                      img_hw=(128, 160))
    make_archdata_dataset(cfg["arch_data"], n_imgs=5)
    _write_vases(os.path.join(cfg["det_data"], VASES), 5)
    # the experiments (01_create_experiment's work, done once per run)
    cfg["experiments"] = {tag: {kind: create_experiment(
        f"{tag}_{kind}", overrides, root=str(ws / f"{tag}_experiments"))
        for kind, overrides in (("pose", POSE_TRAIN),
                                *((d, DET_TRAIN) for d in DETECTORS),
                                ("arch", {"batch_size": 3}),
                                ("vase", {"batch_size": VASE_B}))}
        for tag in ("one", "two")}
    (ws / "cfg.json").write_text(json.dumps(cfg))
    one = engine_runs(str(ws), "one")
    launch(ws, _BODY, timeout=600)
    return one, results(ws), ws


def _rel(got, want, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def _params_close(got, want, tol=1e-4):
    """Each tensor within ``tol`` of its largest magnitude, or of 1e-3
    for one within 1e-3 of zero: in EfficientDet some BatchNorm biases
    (ahead of another BatchNorm, so their gradient is zero but for
    rounding) and the running means of such layers' inputs are ~1e-10,
    rounding's own size."""
    for k, v in want.items():
        if v.is_floating_point():
            assert _rel(got[k], v, floor=1e-3) <= tol, k


def test_pose_trainer_two_ranks_match_one_rank(runs):
    one, ranks, _ = runs
    assert one["trainer"]["mesh"] == 1
    for res in ranks:
        assert res["trainer"]["mesh"] == 2
        assert res["trainer"]["files"] == one["trainer"]["files"]
        _params_close(res["trainer"]["params"], one["trainer"]["params"])


def test_pose_trainer_logs_come_from_rank_zero(runs):
    """The training logs of the two-rank run (written by rank 0) against
    the one-process run's."""
    cfg = json.loads((runs[2] / "cfg.json").read_text())
    logs = [json.load(open(os.path.join(cfg["experiments"][tag]["pose"],
                                        "training_logs.json")))
            for tag in ("one", "two")]
    assert logs[0]["iterations"] == logs[1]["iterations"] == 2
    for key, split in (("loss", "training"), ("loss", "validation")):
        assert _rel(logs[1][key][split], logs[0][key][split]) <= 1e-4
    for split in ("training", "validation"):
        assert logs[1]["accuracy"][split] == logs[0]["accuracy"][split]


def test_pose_evaluator_two_ranks_match_one_rank(runs):
    """The submission and its AP; the loss and PCK are the global batch's
    on both ranks (they count the padding's repeated crops, as the
    reference's on a multi-device mesh, so they are not the one-process
    run's)."""
    one, ranks, _ = runs
    ref = one["evaluator"]
    assert len(ref["preds"]) == 12 and np.isfinite(ref["stats"]).all()
    assert ranks[0]["evaluator"]["loss"] == ranks[1]["evaluator"]["loss"]
    assert ranks[0]["evaluator"]["acc"] == ranks[1]["evaluator"]["acc"]
    for res in (r["evaluator"] for r in ranks):
        np.testing.assert_allclose(res["stats"], ref["stats"], atol=1e-6)
        assert np.isfinite(res["loss"])
        assert len(res["preds"]) == len(ref["preds"])
        for g, r in zip(res["preds"], ref["preds"]):
            assert g["image_id"] == r["image_id"]
            kg = np.reshape(g["keypoints"], (17, 3))
            kr = np.reshape(r["keypoints"], (17, 3))
            np.testing.assert_allclose(kg[:, :2], kr[:, :2], atol=1e-3)
            np.testing.assert_allclose(kg[:, 2], kr[:, 2], atol=1e-5)


@pytest.mark.parametrize("name", DETECTORS)
def test_detector_trainer_two_ranks_match_one_rank(runs, name):
    """One epoch of two steps (one image a rank), then the evaluator's AP
    over the valid split (3 images, padded to 4)."""
    one, ranks, _ = runs
    ref = one[name]
    for res in (r[name] for r in ranks):
        assert _rel(res["logs"]["train_loss"], ref["logs"]["train_loss"]) \
            <= 1e-4
        assert res["logs"]["valid_ap"] == ref["logs"]["valid_ap"]
        _params_close(res["params"], ref["params"])
        np.testing.assert_allclose(res["stats"], ref["stats"], atol=1e-6)


def test_extractor_two_ranks_match_one_rank(runs):
    one, ranks, _ = runs
    ref = one["extractor"]["db"]
    assert len(ref) > 0 and one["extractor"]["written"]
    for res in (r["extractor"] for r in ranks):
        assert res["written"] and list(res["db"]) == list(ref)
        for k, r in ref.items():
            g = res["db"][k]
            assert (g["img"], g["character_name"]) == (r["img"],
                                                       r["character_name"])
            np.testing.assert_allclose(g["joints"], r["joints"], atol=1e-3)


def _results_close(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert len(g["boxes"]) == len(r["boxes"])
        np.testing.assert_allclose(g["boxes"], r["boxes"], atol=1e-4)
        np.testing.assert_allclose(g["scores"], r["scores"], atol=1e-6)
        for k in ("crop_keypoints", "image_keypoints"):
            assert g[k].shape == r[k].shape
            np.testing.assert_allclose(g[k][..., :2], r[k][..., :2],
                                       atol=1e-3)
            np.testing.assert_allclose(g[k][..., 2], r[k][..., 2],
                                       atol=1e-5)


def test_vase_host_path_on_two_ranks_matches_one_rank(runs):
    """Each rank detects its rows of the 3 images (padded to 4), crops
    and poses its half of the bucketed crop budget; the default path on
    two ranks is the host path."""
    one, ranks, _ = runs
    counts = [len(r["boxes"]) for r in one["vase"]["host"]]
    assert len(set(counts)) > 1, counts
    for res in (r["vase"] for r in ranks):
        _results_close(res["host"], one["vase"]["host"])
        _results_close(res["default"], one["vase"]["host"])


def test_sharded_fused_two_stage_matches_one_process_fused(runs):
    """4 images, 2 a rank, each rank's budget 2 * max_dets: per image,
    the one-process fused program's boxes and keypoints."""
    one, ranks, _ = runs
    _results_close(one["vase"]["fused"][:3], one["vase"]["host"])
    for res in (r["vase"] for r in ranks):
        _results_close(res["fused"], one["vase"]["fused"])


def test_fused_on_a_mesh_needs_a_divisible_batch(runs):
    one, ranks, _ = runs
    assert one["vase"]["ragged_fused"] == "ran"
    for res in (r["vase"] for r in ranks):
        assert "divisible by the mesh" in res["ragged_fused"]
        assert res["n_done"] == one["vase"]["n_done"] == 5
