"""COCO scoring of the port against the JAX package's on the same seeded
scenes: the COCO index and ``loadRes`` (stlpose_tpu_torch/data/coco_api.py),
COCOeval (stlpose_tpu_torch/eval/cocoeval.py) on the fuzz scenes of
tests/test_cocoeval_differential.py, the host OKS and IoU NMS
(stlpose_tpu_torch/ops/nms.py) and the submission pipeline
(stlpose_tpu_torch/eval/submission.py). Both sides are numpy in float64
and the same operations, so keep lists, files and stats agree exactly
(stats to 1e-12)."""

import copy
import json

import numpy as np
import pytest

from stlpose_tpu.data.coco_api import COCO as JaxCOCO
from stlpose_tpu.eval import cocoeval as jax_cocoeval
from stlpose_tpu.eval import submission as jax_sub
from stlpose_tpu.ops import nms as jax_nms
from stlpose_tpu_torch.data.coco_api import COCO, coco_from_dataset
from stlpose_tpu_torch.eval import cocoeval
from stlpose_tpu_torch.eval import submission
from stlpose_tpu_torch.ops import nms
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


def _poses(seed, n=12, n_img=3):
    """Person dicts in clusters (near-duplicates that OKS-NMS suppresses),
    with quantized scores (ties) and some low joint scores."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(50, 400, (4, 17, 2))
    preds = np.zeros((n, 17, 3))
    for i in range(n):
        preds[i, :, :2] = base[i % 4] + rng.randn(17, 2) * rng.choice(
            [1.0, 8.0, 40.0])
        preds[i, :, 2] = rng.uniform(0.0, 1.0, 17)
    boxes = np.concatenate([rng.uniform(100, 300, (n, 2)),
                            rng.uniform(0.5, 2.0, (n, 2)),
                            rng.uniform(2e3, 4e4, (n, 1)),
                            np.round(rng.uniform(0.3, 1.0, (n, 1)), 1)], 1)
    ids = [int(i % n_img) + 1 for i in range(n)]
    return preds, boxes, ids


@pytest.mark.parametrize("in_vis_thre", [None, 0.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_oks_and_box_nms_match_jax(seed, in_vis_thre):
    preds, boxes, _ = _poses(seed)
    db = [{"keypoints": preds[i], "score": float(boxes[i, 5]),
           "area": float(boxes[i, 4])} for i in range(len(preds))]
    np.testing.assert_array_equal(
        nms.oks_iou(preds[0].ravel(), preds[1:].reshape(len(preds) - 1, -1),
                    boxes[0, 4], boxes[1:, 4], in_vis_thre=in_vis_thre),
        jax_nms.oks_iou(preds[0].ravel(),
                        preds[1:].reshape(len(preds) - 1, -1), boxes[0, 4],
                        boxes[1:, 4], in_vis_thre=in_vis_thre))
    for thr in (0.3, 0.9):
        keep = nms.oks_nms(db, thr, in_vis_thre=in_vis_thre)
        assert keep == jax_nms.oks_nms(db, thr, in_vis_thre=in_vis_thre)
        assert 0 < len(keep) < len(db)
        assert nms.soft_oks_nms(db, thr, max_dets=8,
                                in_vis_thre=in_vis_thre) == \
            jax_nms.soft_oks_nms(db, thr, max_dets=8,
                                 in_vis_thre=in_vis_thre)
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (30, 2))
    dets = np.concatenate([xy, xy + rng.uniform(5, 80, (30, 2)),
                           np.round(rng.rand(30, 1), 1)], 1)
    for thr in (0.3, 0.7):
        keep = nms.box_nms(dets, thr)
        assert keep == jax_nms.box_nms(dets, thr) and 0 < len(keep) < 30
    assert nms.oks_nms([], 0.9) == nms.box_nms(np.zeros((0, 5)), 0.5) == []


@pytest.mark.parametrize("soft", [False, True])
def test_rescore_and_nms_matches_jax(soft):
    preds, boxes, ids = _poses(3)
    got = submission.rescore_and_nms(preds, boxes, ids, soft=soft)
    ref = jax_sub.rescore_and_nms(preds, boxes, ids, soft=soft)
    assert len(got) == len(ref) == 3
    for g_img, r_img in zip(got, ref):
        assert len(g_img) == len(r_img)
        for g, r in zip(g_img, r_img):
            assert g.keys() == r.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


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
