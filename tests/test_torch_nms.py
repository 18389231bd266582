"""K5's function, greedy pick-argmax NMS: ``ops/nms.py::box_nms_topk`` on
CPU tensors (its plain version, ``kernels/nms.py::box_nms_topk_plain``)
against ``stlpose_tpu.ops.nms.box_nms_jax(max_keep=...)`` on the same
seeded numpy cases, keep masks equal bit for bit. The kernel itself is
held against the plain version on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.nms import box_nms_jax
from stlpose_tpu_torch.kernels import nms as _k5
from stlpose_tpu_torch.ops.nms import box_nms_topk


def _boxes(rng, B, M, extent=80.0, size=40.0):
    xy = rng.uniform(0, extent, (B, M, 2))
    wh = rng.uniform(0, size, (B, M, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name):
    """(boxes (B, M, 4) f32, scores (B, M) f32, valid (B, M) bool or None,
    threshold, max_keep, bf16 scores) of one planted case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    B, M = 3, 48
    boxes = _boxes(rng, B, M)
    scores = rng.uniform(0, 1, (B, M)).astype(np.float32)
    valid = rng.rand(B, M) > 0.1
    thr, max_keep, bf16 = 0.5, 16, False
    if name == "tied_scores":
        boxes[:, 10:14] = boxes[:, 10:11]             # duplicates, tied
        scores[:, 10:14] = 0.75
        scores[:, 20:30] = 0.25                       # ties, apart
        boxes[:, 30] = (0, 0, 2, 2)                   # IoU exactly 0.5:
        boxes[:, 31] = (0, 0, 2, 1)                   # not above thr
        scores[:, 30:32] = (0.999, 0.998)
        scores[:, 40] = -0.0                          # -0.0 ties +0.0
        scores[:, 41] = 0.0
        valid[:, 10:14] = valid[:, 30:32] = valid[:, 40:42] = True
        max_keep = 48
    elif name == "zero_area_top":
        boxes[:, :6, 2:] = boxes[:, :6, :2]           # self-IoU 0
        boxes[:, 6, 2] = boxes[:, 6, 0]               # zero width only
        scores[:, :7] = np.linspace(0.99, 0.93, 7)
        valid[:, :7] = True
    elif name == "dead_rows":
        scores[0] = -np.inf                           # all -inf
        valid[1] = False                              # all invalid
        scores[2, ::3] = -np.inf
    elif name == "fewer_alive_than_max_keep":
        valid[:] = False
        valid[:, 5:10] = True
        valid[2, :] = False
        valid[2, 47] = True
        max_keep = 40
    elif name == "bf16_scores":
        scores = rng.randint(0, 6, (B, M)).astype(np.float32) / 8.0 + 0.3
        scores = torch.from_numpy(scores).bfloat16().float().numpy()
        bf16 = True                                   # many exact ties
    elif name == "level_offset_proposals":
        # select_proposals' form: per-level boxes shifted apart by
        # level * 2 * image size, so levels never suppress each other
        B, M = 2, 60
        boxes = _boxes(rng, B, M, extent=50.0, size=30.0)
        boxes += (np.arange(M) // 20)[None, :, None] * 128.0
        scores = rng.randn(B, M).astype(np.float32)
        wh_ok = ((boxes[..., 2] - boxes[..., 0]) >= 1e-3) & \
            ((boxes[..., 3] - boxes[..., 1]) >= 1e-3)
        valid = wh_ok
        scores = np.where(wh_ok, scores, -np.inf).astype(np.float32)
        thr, max_keep = 0.7, 24
    elif name == "no_valid_mask":
        valid = None
        scores[:, 3] = -np.inf
    return boxes, scores, valid, thr, max_keep, bf16


@pytest.mark.parametrize("name", [
    "tied_scores", "zero_area_top", "dead_rows", "fewer_alive_than_max_keep",
    "bf16_scores", "level_offset_proposals", "no_valid_mask"])
def test_nms_keep_mask_matches_jax(name):
    boxes, scores, valid, thr, max_keep, bf16 = _case(name)
    sc = torch.from_numpy(scores)
    launches = _k5.LAUNCHES
    got = box_nms_topk(torch.from_numpy(boxes),
                       sc.bfloat16() if bf16 else sc, thr,
                       None if valid is None else torch.from_numpy(valid),
                       max_keep).numpy()
    assert _k5.LAUNCHES == launches                 # CPU: the plain version
    if valid is None:
        ref = jax.vmap(lambda b, s: box_nms_jax(b, s, thr, max_keep=max_keep))(
            jnp.asarray(boxes), jnp.asarray(scores))
    else:
        ref = jax.vmap(lambda b, s, v: box_nms_jax(
            b, s, thr, valid_mask=v, max_keep=max_keep))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(ref))
    if name == "tied_scores":
        assert got[:, 10].all() and not got[:, 11:14].any()
        assert got[:, 30:32].all()                  # IoU 0.5 is not > 0.5
    elif name == "zero_area_top":
        assert got[:, :7].all()                     # kept once each
    elif name == "dead_rows":
        assert not got[:2].any() and got[2].any()
    elif name == "fewer_alive_than_max_keep":
        assert got.sum(1).max() <= 5 and got[2, 47] and got[2].sum() == 1
