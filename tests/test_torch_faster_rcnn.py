"""Faster R-CNN inference and its NMS: the PyTorch port against the JAX
reference on the same weights (FASTER_RCNN_TINY, carried across by
stlpose_tpu_torch/models/convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stlpose_tpu.models.faster_rcnn import FASTER_RCNN_TINY as JAX_TINY
from stlpose_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from stlpose_tpu.ops import boxes as jax_boxes
from stlpose_tpu.ops.nms import box_nms_jax
from stlpose_tpu_torch.config import FASTER_RCNN_TINY
from stlpose_tpu_torch.models.convert import faster_rcnn_from_jax
from stlpose_tpu_torch.ops.boxes import box_iou, clip_boxes, decode_boxes
from stlpose_tpu_torch.ops.nms import box_nms_topk, top_k
from tests.test_torch_hrnet import random_variables


def jax_detector(seed):
    det = JaxFasterRCNN(JAX_TINY, pallas_roi=False)
    abstract = jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0)))
    return det, random_variables(abstract, seed)


def test_nms_keep_masks_match_jax_exactly():
    """Pick-argmax NMS batched over images: zero-area boxes (self-IoU 0,
    must not be re-picked), exactly tied scores (lowest index first),
    -inf scores and invalid slots give the reference's keep mask."""
    rng = np.random.RandomState(0)
    B, M = 3, 40
    xy = rng.uniform(0, 80, (B, M, 2))
    wh = rng.uniform(0, 40, (B, M, 2))
    wh[:, :5] = 0.0                                   # zero-area boxes
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 10:14] = boxes[:, 10:11]                 # duplicated boxes
    scores = rng.uniform(0, 1, (B, M)).astype(np.float32)
    scores[:, 10:14] = 0.5                            # ... with tied scores
    scores[:, 0:3] = 0.99                             # degenerate on top
    scores[:, 20:23] = -np.inf
    valid = rng.rand(B, M) > 0.15
    for max_keep in (5, 64):
        got = box_nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.5, torch.from_numpy(valid), max_keep).numpy()
        for b in range(B):
            ref = np.asarray(box_nms_jax(
                jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.5,
                valid_mask=jnp.asarray(valid[b]), max_keep=max_keep))
            np.testing.assert_array_equal(got[b], ref)
    assert got[:, :3].any()                  # degenerate boxes were kept


def test_box_ops_match_jax():
    """IoU (zero-area and disjoint pairs included), delta decoding with
    the exp clip reached, and clipping to the canvas: the same f32
    operations in the same order, run op by op on both sides; 1e-6
    relative for the exp of the box sizes, exact otherwise."""
    rng = np.random.RandomState(3)
    xy = rng.uniform(-20, 120, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 50, (12, 2))],
                           -1).astype(np.float32)
    boxes[:2, 2:] = boxes[:2, :2]                     # zero-area boxes
    deltas = rng.randn(12, 4).astype(np.float32)
    deltas[:3, 2:] = 60.0                             # above the exp clip
    with jax.disable_jit():
        iou = np.asarray(jax_boxes.box_iou(boxes, boxes[::-1]))
        dec = np.asarray(jax_boxes.decode_boxes(deltas, boxes,
                                                (10.0, 10.0, 5.0, 5.0)))
        clip = np.asarray(jax_boxes.clip_boxes(dec, (100, 90)))
    T = torch.from_numpy
    np.testing.assert_array_equal(
        box_iou(T(boxes), T(boxes[::-1].copy())).numpy(), iou)
    got = decode_boxes(T(deltas), T(boxes), (10.0, 10.0, 5.0, 5.0))
    np.testing.assert_allclose(got.numpy(), dec, rtol=1e-6, atol=0)
    np.testing.assert_allclose(clip_boxes(got, (100, 90)).numpy(), clip,
                               rtol=1e-6, atol=0)
    assert (iou == 0).any() and (iou > 0).any()
    assert clip.min() == 0.0 and clip[..., 0::2].max() == 90.0


def test_top_k_orders_ties_like_jax():
    x = np.array([[0.5, -np.inf, 0.5, 2.0, -np.inf, 0.0, 0.5, 0.0]],
                 np.float32)
    v, i = top_k(torch.from_numpy(x), 6)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_predict_matches_jax():
    """FASTER_RCNN_TINY predict on two 128-px images. The valid set and
    labels are exact; boxes within 1e-3 px and scores within 1e-5 (f32
    convolutions summed in another order). Stable because the kept
    scores are separated from each other and from the score threshold
    by far more than that rounding (asserted below)."""
    det, variables = jax_detector(0)
    imgs = np.random.RandomState(1).rand(2, 128, 128, 3).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in
           jax.jit(det.predict)(variables, jnp.asarray(imgs)).items()}
    port = faster_rcnn_from_jax(variables, FASTER_RCNN_TINY, device="cpu")
    got = {k: v.numpy() for k, v in port.predict(torch.from_numpy(imgs))
           .items()}

    v = ref["valid"]
    assert v.sum() >= 8                              # real detections
    for b in range(2):
        s = np.sort(ref["scores"][b][v[b]])
        assert np.diff(s).min() > 1e-4
        assert s.min() - FASTER_RCNN_TINY.score_thresh > 1e-4
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3,
                               rtol=0)
