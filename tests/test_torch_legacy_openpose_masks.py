"""The port's legacy OpenPose masks (``data/legacy_openpose.py``:
``segmentation_to_mask`` on RLE strings, bytes, counts and polygons, and
the person mask) against the JAX package's, equal. Split from
``tests/test_torch_legacy_openpose.py`` so that each test file of the
port holds at most 12 tests (pytest-xdist's ``--dist loadfile`` queues
files largest first)."""

import numpy as np
import pytest

from stlpose_tpu.data import legacy_openpose as jax_lo
from stlpose_tpu_torch.data import legacy_openpose as lo
from tests.test_legacy_openpose import _encode_rle_counts_string


def rle_case(seed=4, h=13, w=9):
    """A random mask and its column-major run counts."""
    ref = np.random.RandomState(seed).rand(h, w) > 0.5
    counts, run_val, run_len = [], 0, 0
    for v in ref.T.reshape(-1):
        if bool(v) == bool(run_val):
            run_len += 1
        else:
            counts.append(run_len)
            run_val, run_len = int(v), 1
    counts.append(run_len)
    return ref, counts


def polygons(seed, n=3, h=24, w=32):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        poly = []
        for _ in range(rng.randint(3, 8)):
            poly += [float(rng.uniform(-2, w + 2)),
                     float(rng.uniform(-2, h + 2))]
        out.append(poly)
    return out


@pytest.mark.parametrize("kind", ["rle string", "rle bytes", "rle counts",
                                  "polygons", "degenerate polygon"])
def test_segmentation_to_mask_equal(kind):
    ref, counts = rle_case()
    h, w = ref.shape
    seg = {"rle string": {"counts": _encode_rle_counts_string(counts),
                          "size": [h, w]},
           "rle bytes": {"counts": _encode_rle_counts_string(counts)
                         .encode(), "size": [h, w]},
           "rle counts": {"counts": counts, "size": [h, w]},
           "polygons": polygons(3),
           "degenerate polygon": [[1.0, 1.0, 5.0, 5.0]]}[kind]
    if kind == "polygons":
        h, w = 24, 32
    got = lo.segmentation_to_mask(seg, h, w)
    np.testing.assert_array_equal(got, jax_lo.segmentation_to_mask(seg, h, w))
    if kind.startswith("rle"):
        np.testing.assert_array_equal(got.astype(bool), ref)
    if kind in ("rle string", "rle bytes"):
        assert lo._decode_rle_counts_string(seg["counts"]) == \
            jax_lo._decode_rle_counts_string(seg["counts"])


@pytest.mark.parametrize("case", ["two squares", "polygons and rle",
                                  "no segmentation", "no people"])
def test_person_mask_equal(case):
    sq1 = [5.0, 5.0, 15.0, 5.0, 15.0, 15.0, 5.0, 15.0]
    sq2 = [25.0, 25.0, 35.0, 25.0, 35.0, 35.0, 25.0, 35.0]
    ref, counts = rle_case(seed=6, h=40, w=40)
    anns = {"two squares": [{"segmentation": [sq1, sq2]},
                            {"segmentation": []}],
            "polygons and rle": [{"segmentation": polygons(7, w=40, h=40)},
                                 {"segmentation": {"counts": counts,
                                                   "size": [40, 40]}}],
            "no segmentation": [{"keypoints": [0] * 51}],
            "no people": []}[case]
    got = lo.person_mask((40, 40), anns)
    np.testing.assert_array_equal(got, jax_lo.person_mask((40, 40), anns))
    if case == "two squares":     # unioned, not the first polygon only
        assert got[10, 10] == got[30, 30] == 0.0 and got[20, 20] == 1.0
