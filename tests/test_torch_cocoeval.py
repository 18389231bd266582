"""COCO scoring of the port against the JAX package's on the same seeded
scenes: the COCO index and ``loadRes`` (stlpose_tpu_torch/data/coco_api.py),
COCOeval (stlpose_tpu_torch/eval/cocoeval.py) on the fuzz scenes of
tests/test_cocoeval_differential.py and the submission file and precision
(stlpose_tpu_torch/eval/submission.py); the host NMS and the rescoring
are in tests/test_torch_cocoeval_nms.py. Both sides are numpy in float64
and the same operations, so keep lists, files and stats agree exactly
(stats to 1e-12)."""

import copy
import json

import numpy as np
import pytest

from stlpose_tpu.data.coco_api import COCO as JaxCOCO
from stlpose_tpu.eval import cocoeval as jax_cocoeval
from stlpose_tpu.eval import submission as jax_sub
from stlpose_tpu_torch.data.coco_api import COCO, coco_from_dataset
from stlpose_tpu_torch.eval import cocoeval
from stlpose_tpu_torch.eval import submission
from tests.test_cocoeval_differential import make_case


def _stats(mod, coco_cls, dataset, dt_anns, iou_type):
    gt = coco_cls(copy.deepcopy(dataset))
    ev = mod.COCOeval(gt, gt.loadRes(copy.deepcopy(dt_anns)), iou_type)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_type", ["bbox", "keypoints"])
def test_cocoeval_matches_jax(iou_type, seed, capsys):
    """Five fuzz scenes a case: crowds, ignores, empty images, score ties,
    every area range."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(5):
        gt, _, dt_anns, _, _ = make_case(rng, iou_type)
        ref = _stats(jax_cocoeval, JaxCOCO, gt.dataset, dt_anns, iou_type)
        got = _stats(cocoeval, COCO, gt.dataset, dt_anns, iou_type)
        capsys.readouterr()
        assert got.shape == ref.shape == ((12,) if iou_type == "bbox"
                                          else (10,))
        np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)


def test_coco_index_and_load_res_match_jax():
    """Id queries with each filter, loadCats, and loadRes's area and
    keypoint-extent bbox rules, on a keypoint scene and a bbox scene."""
    rng = np.random.RandomState(7)
    for iou_type in ("keypoints", "bbox"):
        gt, gt_anns, dt_anns, img_ids, cat_ids = make_case(rng, iou_type)
        ref, got = JaxCOCO(copy.deepcopy(gt.dataset)), COCO(
            copy.deepcopy(gt.dataset))
        queries = [((), {}), ((), {"imgIds": img_ids[:2]}),
                   ((), {"catIds": cat_ids[-1:]}),
                   ((), {"areaRng": [32 ** 2, 96 ** 2]}),
                   ((), {"iscrowd": 0}),
                   ((), {"imgIds": img_ids[1:], "catIds": cat_ids[:1],
                         "iscrowd": 1})]
        for args, kw in queries:
            assert got.getAnnIds(*args, **kw) == ref.getAnnIds(*args, **kw)
        for kw in ({}, {"imgIds": img_ids[1:]}, {"catIds": cat_ids[:1]},
                   {"imgIds": img_ids[:2], "catIds": cat_ids}):
            assert got.getImgIds(**kw) == ref.getImgIds(**kw)
        for kw in ({}, {"catNms": ["1"]}, {"catIds": cat_ids[-1:]}):
            assert got.getCatIds(**kw) == ref.getCatIds(**kw)
        assert got.loadCats(cat_ids) == ref.loadCats(cat_ids)
        res = [{k: v for k, v in d.items() if k not in ("bbox", "area")}
               if iou_type == "keypoints" else
               {k: v for k, v in d.items() if k != "area"} for d in dt_anns]
        assert got.loadRes(copy.deepcopy(res)).dataset == \
            ref.loadRes(copy.deepcopy(res)).dataset
    samples = [{"image_id": 3, "height": 40, "width": 50,
                "boxes": [[1, 2, 11, 22], [5, 5, 9, 30]], "labels": [1, 2],
                "keypoints": rng.rand(2, 17, 3) * 10}]
    from stlpose_tpu.data.coco_api import coco_from_dataset as jax_from
    assert coco_from_dataset(samples).dataset == jax_from(samples).dataset


def test_submission_file_and_precision_match_jax(tmp_path, capsys):
    """Two writes into one file (the second merges into the first), then
    keypoint AP over the evaluated images, and bbox AP on a bbox scene."""
    rng = np.random.RandomState(11)
    gt, gt_anns, _, img_ids, _ = make_case(rng, "keypoints")
    while len(gt_anns) < 4:
        gt, gt_anns, _, img_ids, _ = make_case(rng, "keypoints")
    kp = np.array([g["keypoints"] for g in gt_anns]).reshape(-1, 17, 3)
    preds = kp.copy()
    preds[..., :2] += rng.randn(len(kp), 17, 2) * 3.0
    preds[..., 2] = rng.uniform(0.1, 1.0, (len(kp), 17))
    boxes = np.array([[b[0] + b[2] / 2, b[1] + b[3] / 2, b[2] / 200,
                       b[3] / 200, b[2] * b[3], 1.0]
                      for b in (g["bbox"] for g in gt_anns)])
    ids = [g["image_id"] for g in gt_anns]
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps(gt.dataset))
    files = {}
    for tag, mod in (("port", submission), ("jax", jax_sub)):
        f = str(tmp_path / f"{tag}.json")
        half = len(ids) // 2
        mod.generate_submission(preds[:half], boxes[:half], ids[:half], f)
        mod.generate_submission(preds[half:], boxes[half:], ids[half:], f)
        files[tag] = (f, json.loads(open(f).read()))
    assert files["port"][1] == files["jax"][1]
    assert len(files["port"][1]) > 0
    got = submission.compute_precision(files["port"][0], str(labels))
    ref = jax_sub.compute_precision(files["jax"][0], str(labels))
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    assert got[0] > 0

    bgt, _, bdt, bimg, _ = make_case(rng, "bbox")
    got = submission.compute_detection_ap(copy.deepcopy(bdt),
                                          COCO(copy.deepcopy(bgt.dataset)),
                                          bimg)
    ref = jax_sub.compute_detection_ap(copy.deepcopy(bdt),
                                       JaxCOCO(copy.deepcopy(bgt.dataset)),
                                       bimg)
    capsys.readouterr()
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
