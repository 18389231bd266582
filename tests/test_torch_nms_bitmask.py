"""K5's formulation (a stable key sort, the upper-triangle IoU bitmask, a
scan in chunks of 64), written out in plain torch, against the plain
pick-argmax loop (``kernels/nms.py::box_nms_topk_plain``) and
``stlpose_tpu.ops.nms.box_nms_jax`` on the seeded cases of
``tests/test_torch_nms.py``, bit for bit. Split from that file so that
each test file of the port holds at most 12 tests (pytest-xdist's
``--dist loadfile`` queues files largest first)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.ops.nms import box_nms_jax
from stlpose_tpu_torch.kernels import nms as _k5
from tests.test_torch_nms import _case
import tests.torch_threads  # noqa: F401  (caps torch's threads)


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
