"""The port's host-side drawing and detection bookkeeping against the JAX
package, on seeded inputs: ``ops/bbox_utils.py`` and
``ops/pose_entries.py`` exactly, and every function of
``utils/visualization.py`` to the same decoded PNG pixels."""

import numpy as np
import pytest

from stlpose_tpu import constants as jax_constants
from stlpose_tpu.ops import bbox_utils as jax_bbox
from stlpose_tpu.ops import pose_entries as jax_entries
from stlpose_tpu.utils import visualization as jax_vis
from stlpose_tpu_torch import constants
from stlpose_tpu_torch.ops import bbox_utils, pose_entries
from stlpose_tpu_torch.utils import visualization


def _detections(rng, n=2, d=12):
    xy = rng.uniform(0, 300, (n, d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 120, (n, d, 2))], -1)
    return {"boxes": boxes.astype(np.float32),
            "labels": rng.randint(1, 3, (n, d)).astype(np.int32),
            "scores": rng.rand(n, d).astype(np.float32),
            "valid": rng.rand(n, d) > 0.2}


def _keypoints(rng, p=3):
    kp = rng.uniform(0, 200, (p, 17, 2))
    kp[rng.rand(p, 17) < 0.2] = -1
    return kp


def _cases(rng):
    dets = _detections(rng)
    boxes, labels, scores = jax_bbox.bbox_filtering(dets, thr=0.3)[0]
    kp = _keypoints(rng)
    mv = rng.rand(3, 17)
    entries, allk = jax_entries.create_pose_entries(kp, mv)
    return {
        "bbox_filtering": ((dets,), {"thr": 0.3}),
        "bbox_filtering_single": (({k: v[1] for k, v in dets.items()},),
                                  {"thr": 0.5, "filter_class": 2}),
        "bbox_nms": ((boxes, labels, scores), {"nms_thr": 0.3}),
        "bbox_nms_empty": ((boxes[:0], labels[:0], scores[:0]), {}),
        "bbox_to_image_keypoints": ((rng.uniform(0, 256, (3, 17, 3)),
                                     boxes[:3]), {}),
        "create_pose_entries": ((kp, mv), {"thr": 0.4}),
        "create_pose_entries_empty": ((kp[:0],), {}),
        "convert_to_coco_format": ((entries, allk), {}),
        "convert_to_coco_format_empty": (([], allk[:0]), {}),
        "unnormalize": ((rng.randn(256, 192, 3).astype(np.float32),), {}),
        "unnormalize_0_255": ((rng.uniform(0, 255, (8, 8, 3)),), {}),
    }


def _equal(got, ref):
    if isinstance(ref, (tuple, list)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", sorted(_cases(np.random.RandomState(0))))
def test_bbox_utils_and_pose_entries_match_jax(case):
    args, kw = _cases(np.random.RandomState(0))[case]
    name = case.replace("_single", "").replace("_empty", "") \
        .replace("_0_255", "")
    port = getattr(bbox_utils if name.startswith("bbox") else pose_entries,
                   name)
    ref = getattr(jax_bbox if name.startswith("bbox") else jax_entries,
                  name)
    _equal(port(*args, **kw), ref(*args, **kw))


def test_skeleton_tables_match_jax():
    for k in ("SKELETON_HRNET", "SKELETON_SIMPLE", "SKELETON_ARCH_DATA",
              "ACCEPTED_MODELS"):
        assert getattr(constants, k) == getattr(jax_constants, k), k
    assert constants.setup_skeleton_map("HRNet") == \
        jax_constants.setup_skeleton_map("HRNet")
    with pytest.raises(NotImplementedError, match="not available"):
        constants.setup_skeleton_map("OpenPose")


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
