"""The port's host NMS (``ops/nms.py``: OKS and box NMS, soft OKS-NMS)
and the submission's rescoring and NMS (``eval/submission.py``) against
the JAX package's on the same seeded poses. Split from
``tests/test_torch_cocoeval.py`` so that each test file of the port holds
at most 12 tests (pytest-xdist's ``--dist loadfile`` queues files largest
first)."""

import numpy as np
import pytest

from stlpose_tpu.eval import submission as jax_sub
from stlpose_tpu.ops import nms as jax_nms
from stlpose_tpu_torch.eval import submission
from stlpose_tpu_torch.ops import nms


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
