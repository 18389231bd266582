"""The port's drawings (``utils/visualization.py``) against the JAX
package's on the same seeded detections and poses: the saved images equal
pixel for pixel. Split from ``tests/test_torch_visualization.py`` so that
each test file of the port holds at most 12 tests (pytest-xdist's
``--dist loadfile`` queues files largest first)."""

import numpy as np
import pytest

from stlpose_tpu import constants as jax_constants
from stlpose_tpu.utils import visualization as jax_vis
from stlpose_tpu_torch import constants
from stlpose_tpu_torch.utils import visualization


def _drawings(rng):
    img = rng.rand(120, 100, 3).astype(np.float32)
    poses = np.concatenate([rng.uniform(0, 100, (2, 17, 2)),
                            rng.rand(2, 17, 1)], -1)
    poses[0, 3, :2] = 0.0                          # a hidden joint
    xy = rng.uniform(0, 60, (3, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (3, 2))], -1)
    return {
        "visualize_image": ((img * 255.0,), {"title": "vase"}),
        "draw_pose": ((img, poses), {"kpt_thr": 0.3}),
        "draw_pose_simple": ((None, poses[0]),
                             {"skeleton": constants.SKELETON_SIMPLE}),
        "visualize_bbox": ((img, boxes, rng.rand(3)), {"title": "dets"}),
        "visualize_heatmaps": ((rng.rand(17, 16, 12),), {"n_cols": 6}),
        "visualize_subset_heatmaps": ((rng.rand(2, 32, 24, 3),
                                       rng.rand(2, 18, 32, 24)), {"n": 2}),
        "visualize_subset_pafs": (
            ((rng.rand(2, 32, 24, 3) * 255).astype(np.uint8),
             np.where(rng.rand(2, 38, 32, 24) > 0.7,
                      rng.randn(2, 38, 32, 24) * 0.1, 0.0)), {"n": 2}),
    }


@pytest.mark.parametrize("case", sorted(_drawings(np.random.RandomState(1))))
def test_visualization_pixels_match_jax(case, tmp_path):
    """Each drawing saved as a PNG by both packages on the same arrays: the
    decoded pixels are equal."""
    import matplotlib.image as mpimg

    args, kw = _drawings(np.random.RandomState(1))[case]
    name = case.replace("_simple", "")
    if name == "draw_pose" and "skeleton" in kw:
        kw_ref = dict(kw, skeleton=jax_constants.SKELETON_SIMPLE)
    else:
        kw_ref = kw
    got, ref = tmp_path / "port.png", tmp_path / "jax.png"
    getattr(visualization, name)(*args, savepath=str(got), **kw)
    getattr(jax_vis, name)(*args, savepath=str(ref), **kw_ref)
    a, b = mpimg.imread(str(got)), mpimg.imread(str(ref))
    assert a.shape == b.shape and a.shape[0] > 50
    np.testing.assert_array_equal(a, b)
