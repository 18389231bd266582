"""The port's legacy OpenPose target generators and person masks
(stlpose_tpu_torch/data/legacy_openpose.py) against the JAX package's,
bit for bit, on the inputs tests/test_legacy_openpose.py uses: random
people (the zero-person case included) and coincident limb ends. The
masks (random polygons, RLE counts lists and compressed strings, unioned
multi-polygon segmentations) are in
tests/test_torch_legacy_openpose_masks.py."""

import numpy as np
import pytest

from stlpose_tpu.data import legacy_openpose as jax_lo
from stlpose_tpu_torch.data import legacy_openpose as lo
from tests.test_legacy_openpose import _random_annotations

H, W = 96, 128


def people(seed, n):
    return _random_annotations(np.random.RandomState(seed), n, H, W)


@pytest.mark.parametrize("seed,n", [(0, 1), (0, 2), (0, 4), (0, 0)])
def test_heatmaps_equal(seed, n):
    anns = people(seed, n)
    got = lo.generate_heatmaps((H, W), anns, sigma=10)
    assert got.shape == (18, H, W)
    np.testing.assert_array_equal(
        got, jax_lo.generate_heatmaps((H, W), anns, sigma=10))
    if n == 0:     # zeros, and a background of ones, not NaN
        np.testing.assert_array_equal(got[:-1], 0.0)
        np.testing.assert_array_equal(got[-1], 1.0)


@pytest.mark.parametrize("case", ["one", "three", "coincident", "none"])
def test_pafs_equal(case):
    anns, limbs = {
        "one": (people(1, 1), lo.COCO_LIMBS),
        "three": (people(1, 3), lo.COCO_LIMBS),
        "coincident": ([{"keypoints": [10, 10, 2] * 17}], ((0, 1),)),
        "none": ([], ((0, 1),)),
    }[case]
    assert lo.COCO_LIMBS == jax_lo.COCO_LIMBS
    got = lo.generate_pafs((H, W), anns, limbs, thickness=5)
    np.testing.assert_array_equal(
        got, jax_lo.generate_pafs((H, W), anns, limbs, thickness=5))
    if case in ("coincident", "none"):
        np.testing.assert_array_equal(got, 0.0)
