"""Legacy OpenPose-era target generators: full-image keypoint heatmaps and
Part Affinity Fields (PAFs).

Port of ``stlpose_tpu/data/legacy_openpose.py``, numpy kept as numpy and
every operation in the same order, so both give the same maps bit for
bit. What follows is the JAX package's description, which holds here.

Working re-design of the reference's bottom-up data helpers
(reference: data/data_processing.py:213-263 ``generate_heatmaps`` /
``add_gaussian``, :294-397 ``generate_paf`` / ``set_paf``). In the
reference these feed no live training path (the top-down HRNet pipeline
uses per-crop targets, ops/heatmap.py here) and depend on module globals
(``BODY_PARTS_KPT_IDS`` is ``None`` until a caller sets it,
data_processing.py:29); they are kept for debugging/visualization parity.
This version is vectorized over the pixel grid and people (no per-pixel
loops), takes the limb table as an explicit argument, and returns zeros
instead of NaN for zero-person images (the reference's ``np.mean`` over an
empty axis emits NaN — a defect, not a behavior worth replicating).

Semantics preserved exactly for >=1 person (pinned by
tests/test_legacy_openpose.py against a literal windowed-loop oracle):

  heatmaps: per keypoint, a 15x15 window of exp(-(dx^2+dy^2)/sigma^2)
    (offsets -7..7, NOTE: /sigma^2, not /(2 sigma^2) — the reference's
    kernel, data_processing.py:203) stamped at the INTEGER keypoint
    location for every person with v>0, MAX-combined over people; a final
    background channel 1 - max over keypoints.
  pafs: per limb (a, b), two channels holding the unit vector (x, y)
    components on pixels within ``thickness`` of the infinite line through
    a and b, restricted to the limb's bbox dilated by ``thickness``
    ([min-t, max+t) — the reference's asymmetric window), MEAN-combined
    over ALL people (invisible limbs contribute zero maps to the mean).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# COCO-keypoint limb pairs in the OpenPose ordering the reference's callers
# injected into BODY_PARTS_KPT_IDS (17-keypoint COCO skeleton)
COCO_LIMBS = (
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
)

_WIN = 7  # the reference's fixed 15x15 kernel half-window


def _keypoints_array(annotations: Sequence[dict], n_keypoints: int):
    """(P, J, 3) float array from COCO-style flat keypoint lists."""
    if not annotations:
        return np.zeros((0, n_keypoints, 3), np.float32)
    kpts = np.asarray([a["keypoints"] for a in annotations], np.float32)
    return kpts.reshape(len(annotations), -1, 3)


def generate_heatmaps(image_shape, annotations: Sequence[dict],
                      sigma: float = 10.0, n_keypoints: int = 17):
    """Full-image per-keypoint Gaussian heatmaps + background channel.

    Args:
      image_shape: (H, W) or (H, W, C) of the source image.
      annotations: COCO-style annotation dicts with 'keypoints'.
      sigma: kernel std (reference default 10, data_processing.py:213).

    Returns:
      (n_keypoints + 1, H, W) float32; last channel is the background map
      ``1 - max_k heatmap_k`` (data_processing.py:251).
    """
    H, W = int(image_shape[0]), int(image_shape[1])
    kpts = _keypoints_array(annotations, n_keypoints)
    if kpts.shape[1] < n_keypoints:
        n_keypoints = kpts.shape[1]
    maps = np.zeros((n_keypoints + 1, H, W), np.float32)

    gy = np.arange(H, dtype=np.float32)[:, None]
    gx = np.arange(W, dtype=np.float32)[None, :]
    for p in range(kpts.shape[0]):
        for k in range(n_keypoints):
            x, y, v = kpts[p, k]
            if v <= 0:
                continue
            # integer stamping position (the reference indexes the fixed
            # kernel with integer offsets)
            xi, yi = int(x), int(y)
            dx = gx - xi
            dy = gy - yi
            g = np.exp(-(dx ** 2 + dy ** 2) / (sigma ** 2))
            window = ((np.abs(dx) <= _WIN) & (np.abs(dy) <= _WIN))
            maps[k] = np.maximum(maps[k], np.where(window, g, 0.0))
    maps[-1] = 1.0 - maps[:-1].max(axis=0)
    return maps


def generate_pafs(image_shape, annotations: Sequence[dict],
                  limbs: Sequence[tuple] = COCO_LIMBS,
                  thickness: float = 5.0, n_keypoints: int = 17):
    """Part Affinity Fields for every limb.

    Returns:
      (2 * len(limbs), H, W) float32 — channels (2i, 2i+1) hold the limb's
      unit-vector (x, y) components (the reference's coordinate swap in
      set_paf, data_processing.py:372-373, nets out to (dx, dy)/norm in
      image x/y), averaged over people.
    """
    H, W = int(image_shape[0]), int(image_shape[1])
    kpts = _keypoints_array(annotations, n_keypoints)
    P = kpts.shape[0]
    out = np.zeros((2 * len(limbs), H, W), np.float32)
    if P == 0:
        return out

    gy = np.arange(H, dtype=np.float32)[:, None]
    gx = np.arange(W, dtype=np.float32)[None, :]
    for i, (ia, ib) in enumerate(limbs):
        acc_x = np.zeros((H, W), np.float32)
        acc_y = np.zeros((H, W), np.float32)
        for p in range(P):
            if ia >= kpts.shape[1] or ib >= kpts.shape[1]:
                continue
            ax, ay, av = kpts[p, ia]
            bx, by, bv = kpts[p, ib]
            if av <= 0 or bv <= 0:
                continue
            dx, dy = bx - ax, by - ay
            norm = float(np.hypot(dx, dy))
            if norm < 1e-7:
                continue
            ux, uy = dx / norm, dy / norm
            # bbox window dilated by thickness; the reference's upper edge
            # is exclusive WITHOUT +1 ([min-t, max+t)), reproduced here
            x_min = int(max(min(ax, bx) - thickness, 0))
            y_min = int(max(min(ay, by) - thickness, 0))
            x_max = int(min(max(ax, bx) + thickness, W))
            y_max = int(min(max(ay, by) + thickness, H))
            window = ((gx >= x_min) & (gx < x_max) &
                      (gy >= y_min) & (gy < y_max))
            # distance to the infinite line through a-b (cross product)
            d = np.abs((gx - ax) * uy - (gy - ay) * ux)
            hit = window & (d <= thickness)
            acc_x += np.where(hit, ux, 0.0)
            acc_y += np.where(hit, uy, 0.0)
        out[2 * i] = acc_x / P
        out[2 * i + 1] = acc_y / P
    return out


# ---------------------------------------------------------------------------
# Person-mask rasterizer (reference: data/data_processing.py:440-470
# ``get_mask`` — dead code there, carried for inventory completeness).
# The reference decodes each annotation's COCO ``segmentation`` with
# pycocotools (polygons via frPyObjects, RLE dicts directly) and zeroes the
# mask where the person is. This version needs no pycocotools: polygons are
# filled with a vectorized even-odd (crossing-number) test at pixel centers
# (x+0.5, y+0.5), and both uncompressed (counts list) and compressed
# (counts string, COCO's 5-bit LEB128 + delta scheme) RLEs are decoded in
# numpy. Two documented divergences from the reference, both defect fixes:
#   * multi-polygon segmentations are UNIONED; the reference keeps only
#     decode(...)[:, :, 0] — the first polygon — silently dropping the rest
#     (data_processing.py:464-466).
#   * polygon boundary pixels follow the pixel-center even-odd convention
#     rather than pycocotools' 5x-upsampled boundary walk; interiors agree,
#     edge pixels can differ by at most the boundary row/column.
# ---------------------------------------------------------------------------


def _decode_rle_counts_string(s) -> list:
    """COCO compressed-RLE counts string -> list of run lengths.

    Each count is a little-endian sequence of 5-bit groups in chars
    (ord - 48), bit 0x20 = continuation, sign-extended via bit 0x10 of the
    last group; counts after the first two are deltas vs counts[i-2].
    """
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: list = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _decode_rle(counts: Sequence[int], height: int, width: int):
    """Run-length counts (column-major, starting with background) -> (H, W)
    uint8 mask."""
    flat = np.zeros(height * width, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((width, height)).T


def _fill_polygon(height: int, width: int, poly: Sequence[float]):
    """Even-odd fill of a flat [x0, y0, x1, y1, ...] polygon at pixel
    centers -> (H, W) bool."""
    xs = np.asarray(poly[0::2], np.float64)
    ys = np.asarray(poly[1::2], np.float64)
    if xs.size < 3:
        return np.zeros((height, width), bool)
    px = np.arange(width, dtype=np.float64) + 0.5
    py = (np.arange(height, dtype=np.float64) + 0.5)[:, None]
    inside = np.zeros((height, width), bool)
    x1 = np.roll(xs, -1)
    y1 = np.roll(ys, -1)
    for ex0, ey0, ex1, ey1 in zip(xs, ys, x1, y1):
        if ey0 == ey1:
            continue
        crosses = (ey0 <= py) != (ey1 <= py)  # (H, 1)
        xint = ex0 + (py - ey0) * (ex1 - ex0) / (ey1 - ey0)  # (H, 1)
        inside ^= crosses & (px[None, :] < xint)
    return inside


def segmentation_to_mask(segmentation, height: int, width: int):
    """One COCO ``segmentation`` field -> (H, W) float32 binary mask.

    Accepts polygon lists (unioned), uncompressed RLE dicts (counts list)
    and compressed RLE dicts (counts str/bytes).
    """
    if isinstance(segmentation, dict):
        counts = segmentation["counts"]
        h, w = segmentation["size"]
        if isinstance(counts, (str, bytes)):
            counts = _decode_rle_counts_string(counts)
        return _decode_rle(counts, int(h), int(w)).astype(np.float32)
    out = np.zeros((height, width), bool)
    for poly in segmentation:
        out |= _fill_polygon(height, width, poly)
    return out.astype(np.float32)


def person_mask(image_shape, annotations: Sequence[dict]):
    """Binary mask that EXCLUDES labeled people: 1 everywhere, 0 on every
    annotated person's segmentation (reference get_mask contract,
    data_processing.py:456-470)."""
    H, W = int(image_shape[0]), int(image_shape[1])
    mask = np.ones((H, W), np.float32)
    for ann in annotations:
        seg = ann.get("segmentation")
        if not seg:
            continue
        m = segmentation_to_mask(seg, H, W)
        if m.shape == (H, W):
            mask[m > 0.5] = 0.0
    return mask
