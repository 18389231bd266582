"""K5's function, greedy pick-argmax NMS: ``ops/nms.py::box_nms_topk`` on
CPU tensors (its plain version, ``kernels/nms.py::box_nms_topk_plain``)
against ``stlpose_tpu.ops.nms.box_nms_jax(max_keep=...)`` on the same
seeded numpy cases, keep masks equal bit for bit; and the kernel's
formulation (a stable key sort, the upper-triangle IoU bitmask, a scan in
chunks of 64), written out in plain torch, against both. The kernel
itself is held against the plain version on the card by
``chip_smoke.py``."""

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
    elif name in ("m37", "m130"):
        # M not a multiple of K5's 64-candidate chunks: one partial chunk,
        # and a partial third one
        M = int(name[1:])
        boxes = _boxes(rng, B, M)
        scores = rng.uniform(0, 1, (B, M)).astype(np.float32)
        scores[:, 9::9] = scores[:, 1:-8:9]           # ties across chunks
        valid = rng.rand(B, M) > 0.1
        max_keep = M // 2
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


def _sorted_bitmask_nms(boxes, scores, thr, valid, max_keep):
    """K5's formulation (``kernels/csrc/nms.cu``) in plain torch, image by
    image: the alive candidates sorted stably by descending score key
    (-0.0 folded to +0.0, so equal scores tie on the index); the upper
    triangle of their "the pick at row i suppresses candidate j" matrix
    packed into 64-bit words, 64 x 64 blocks at or after the diagonal;
    then the scan in chunks of 64: a chunk resolves from its removed word
    and its rows' diagonal words (``_resolve_chunk``), and the next
    chunk's removed word is the OR of every kept row's word for it; the
    scan stops at max_keep keeps. Returns the (B, M) keep mask in
    candidate order."""
    B, M = scores.shape
    sc = scores.float() + 0.0                           # -0.0 -> +0.0
    alive = sc > -torch.inf
    if valid is not None:
        alive &= valid
    u = sc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)
    key = torch.where(alive, key, 0)
    keep = torch.zeros((B, M), dtype=torch.bool)
    bits = torch.ones(64, dtype=torch.int64) << torch.arange(64)
    for b in range(B):
        order = torch.sort(key[b], descending=True, stable=True).indices
        n = int(alive[b].sum())
        bx = boxes[b, order[:n]]
        x1, y1, x2, y2 = bx.unbind(-1)
        area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
        # row i the pick, column j the candidate: the plain version's
        # expression, operand for operand
        inter = (torch.clamp(torch.minimum(x2[None], x2[:, None]) -
                             torch.maximum(x1[None], x1[:, None]), min=0.0) *
                 torch.clamp(torch.minimum(y2[None], y2[:, None]) -
                             torch.maximum(y1[None], y1[:, None]), min=0.0))
        over = inter / torch.clamp(area[None] + area[:, None] - inter,
                                   min=1e-9) > thr
        W = (n + 63) // 64
        pad = torch.zeros((n, W * 64), dtype=torch.bool)
        pad[:, :n] = over
        words = (pad.view(n, W, 64).long() * bits).sum(-1)  # distinct bits
        words = torch.where(torch.arange(W)[None] >= (torch.arange(n) //
                                                      64)[:, None], words, 0)
        words = [[int(x) & (2 ** 64 - 1) for x in row] for row in words]
        removed = [0] * W
        kept_sorted = []
        for c in range(W):
            diag = [words[64 * c + k][c] if 64 * c + k < n else 0
                    for k in range(64)]
            rows = _resolve_chunk(diag, removed[c], min(64, n - 64 * c),
                                  max_keep - len(kept_sorted))
            kept_sorted += [64 * c + k for k in rows]
            if len(kept_sorted) == max_keep:
                break
            for r in kept_sorted:
                if c + 1 < W:
                    removed[c + 1] |= words[r][c + 1]
        keep[b, order[kept_sorted]] = True
    return keep


def _resolve_chunk(diag, rem, left, room):
    """One chunk of the scan as the kernel's warp resolves it, in rounds:
    the sources are the candidates whose row suppresses a later candidate
    still alive; every candidate up to the first source is kept, then the
    source's row removes its later candidates; at most ``room`` kept.
    Returns the kept positions in order."""
    cand = ((1 << left) - 1) & ~rem
    kept = []
    while cand and len(kept) < room:
        alive = [k for k in range(64) if (cand >> k) & 1]
        src = [k for k in alive if diag[k] & cand & ~((2 << k) - 1)]
        upto = src[0] if src else 63
        kept += [k for k in alive if k <= upto][:room - len(kept)]
        if not src or len(kept) == room:
            break
        cand &= ~diag[upto] & ~((2 << upto) - 1)
    return kept


@pytest.mark.parametrize("name", [
    "tied_scores", "zero_area_top", "dead_rows", "fewer_alive_than_max_keep",
    "bf16_scores", "level_offset_proposals", "no_valid_mask", "m37",
    "m130"])
def test_sorted_bitmask_formulation_matches(name):
    """K5's sorted-bitmask formulation equals the plain pick-argmax loop,
    box_nms_jax(max_keep=...) and the first max_keep survivors of the
    full box_nms_jax() (its valid mask the alive candidates: the full
    form does not read -inf scores as dead), bit for bit."""
    boxes, scores, valid, thr, max_keep, bf16 = _case(name)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    st = st.bfloat16() if bf16 else st
    vt = None if valid is None else torch.from_numpy(valid)
    got = _sorted_bitmask_nms(bt, st, thr, vt, max_keep).numpy()
    np.testing.assert_array_equal(
        got, _k5.box_nms_topk_plain(bt, st, thr, vt, max_keep).numpy())
    alive = scores > -np.inf
    if valid is not None:
        alive &= valid
    topk = jax.vmap(lambda b, s, v: box_nms_jax(
        b, s, thr, valid_mask=v, max_keep=max_keep))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(alive))
    full = np.asarray(jax.vmap(lambda b, s, v: box_nms_jax(
        b, s, thr, valid_mask=v))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(alive)))
    np.testing.assert_array_equal(got, np.asarray(topk))
    for b in range(boxes.shape[0]):
        order = np.argsort(-(scores[b] + 0.0), kind="stable")
        first = order[full[b, order]][:max_keep]
        want = np.zeros(boxes.shape[1], bool)
        want[first] = True
        np.testing.assert_array_equal(got[b], want)
