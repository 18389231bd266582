"""The port's device-warp input pipeline (stlpose_tpu_torch/data) against
stlpose_tpu's on the same synthetic COCO records and augmentation seed:
Gaussian targets, records, joints, targets, weights and metadata, and
the crops, which on a 128-multiple canvas come from the two-pass filter
(K4) as ``affine_warp_pallas`` makes them on the TPU. The JAX pipeline
runs op by op (``jax.disable_jit``), as the port rounds; on the CPU its
own gate takes XLA's direct warp, so its crops are compared only on a
canvas where the port takes K2 too, and the two-pass crops are held to
``affine_warp_pallas`` with its kernel body run op by op (see
tests/test_torch_warp_two_pass.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.data.pipeline import PoseDataPipeline as JaxPipeline
from stlpose_tpu.data.pose_dataset import \
    load_coco_pose_records as jax_records
from stlpose_tpu.ops import affine as jax_affine
from stlpose_tpu.ops.heatmap import generate_targets as jax_targets
from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from stlpose_tpu_torch.data.pipeline import PoseDataPipeline
from stlpose_tpu_torch.data.pose_dataset import load_coco_pose_records
from stlpose_tpu_torch.kernels import warp as _k2
from stlpose_tpu_torch.kernels import warp_two_pass as _k4
from stlpose_tpu_torch.ops import affine
from stlpose_tpu_torch.ops.heatmap import generate_targets
from tests.fixtures import make_coco_dataset
from tests.test_torch_warp_two_pass import _pallas

AUG = {"dataset": {"scale_factor": 0.35, "rot_factor": 45, "flip": True,
                   "num_joints_half_body": 8, "prob_half_body": 0.3}}
B = 4


def test_generate_targets_match_jax():
    """Joints inside, on the border and far off the map, visible or not,
    with and without the per-joint weights: within 1e-6."""
    rng = np.random.RandomState(0)
    joints = rng.uniform(-40, 230, (6, 17, 2)).astype(np.float32)
    joints[..., 1] *= 256 / 192
    joints[0, :4] = [[0, 0], [191.9, 255.9], [-13, 5], [205, 300]]
    vis = (rng.rand(6, 17) > 0.3).astype(np.float32)
    for weights in (True, False):
        ref = jax_targets(jnp.asarray(joints), jnp.asarray(vis),
                          use_joint_weights=weights)
        got = generate_targets(torch.from_numpy(joints),
                               torch.from_numpy(vis),
                               use_joint_weights=weights)
        assert np.asarray(ref[0]).sum() > 10
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                       rtol=0)


def test_crop_matrices_and_joint_transform_match_jax():
    """The batched crop matrices (forward and inverse, with a shift) and
    their elementwise application to joints, against the reference run op
    by op: entries within 1e-6 relative and joints within 1e-3 px (the
    port's cos and sin go through float64 and may land an ulp from XLA's
    f32 ones, 3e-5 on a translation of a few hundred px); the host
    float64 matrix equal to the reference's."""
    rng = np.random.RandomState(1)
    cen = rng.uniform(50, 600, (5, 2)).astype(np.float32)
    sca = rng.uniform(0.3, 3.0, (5, 2)).astype(np.float32)
    rot = np.float32([0, 30, -45, 89, -120])
    pts = rng.uniform(-20, 640, (5, 17, 2)).astype(np.float32)
    for inv, shift in ((False, (0.0, 0.0)), (True, (0.1, -0.2))):
        with jax.disable_jit():
            mat = jax_affine.get_affine_matrix(
                jnp.asarray(cen), jnp.asarray(sca), jnp.asarray(rot),
                (192, 256), shift=shift, inv=inv)
            ref = np.asarray(jax_affine.apply_affine(jnp.asarray(pts), mat))
        got_mat = affine.get_affine_matrix(
            torch.from_numpy(cen), torch.from_numpy(sca),
            torch.from_numpy(rot), (192, 256), shift=shift, inv=inv)
        np.testing.assert_allclose(got_mat.numpy(), np.asarray(mat),
                                   rtol=1e-6, atol=1e-6)
        got = affine.apply_affine(torch.from_numpy(pts), got_mat).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-3)
        for i in range(len(rot)):
            np.testing.assert_array_equal(
                affine.get_affine_matrix_np(cen[i], sca[i], rot[i],
                                            (192, 256), shift, inv),
                jax_affine.get_affine_matrix_np(cen[i], sca[i], rot[i],
                                                (192, 256), shift, inv))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    train_json, _ = make_coco_dataset(str(root), n_train=3, n_val=1)
    img_root = str(root / "original_images" / "train2017")
    return train_json, img_root


def test_records_match_jax(coco):
    """GT-box records, with a styled mapping and perceptual losses."""
    train_json, img_root = coco
    mapping = {"%012d" % i: f"styled_{i}_alpha_0.7.jpg" for i in (1, 3)}
    kw = dict(is_train=True, styled_mapping=mapping, styled_img_root="/s",
              alpha="random", perceptual_loss_dict={"styled_1_alpha_0.7.jpg":
                                                    0.42})
    for extra in ({}, kw):
        ref = jax_records(train_json, img_root, **{"is_train": True,
                                                   **extra})
        got = load_coco_pose_records(train_json, img_root,
                                     **{"is_train": True, **extra})
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            for f in ("image", "original_image", "image_id", "alpha",
                      "perceptual_loss", "score"):
                assert getattr(g, f) == getattr(r, f), f
            for f in ("center", "scale", "joints", "joints_vis"):
                np.testing.assert_array_equal(getattr(g, f), getattr(r, f))


def _batches(coco, canvas, seed=3):
    """First augmented batch of both pipelines (one worker each, so the
    augmentation draws come in record order), and the JAX pipeline's raw
    samples of that batch from a second pipeline with the same seed."""
    train_json, img_root = coco
    records = jax_records(train_json, img_root, is_train=True)
    port_records = load_coco_pose_records(train_json, img_root,
                                          is_train=True)
    kw = dict(batch_size=B, is_train=True, exp_data=AUG, num_workers=1,
              seed=seed, canvas_size=canvas)
    with jax.disable_jit():
        ref = next(iter(JaxPipeline(records, device_warp=True, **kw)))
    raw_pipe = JaxPipeline(records, device_warp=True, **kw)
    raw = [raw_pipe._load_one_raw(r) for r in records[:B]]
    got = next(iter(PoseDataPipeline(port_records, device="cpu", **kw)))
    return ref, raw, got


def _check_labels(ref, got, n_valid=B):
    np.testing.assert_allclose(got["joints"].numpy(), np.asarray(ref["joints"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["target"].numpy(),
                               np.asarray(ref["target"]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.asarray(ref["target_weight"]))
    for k in ("joints_vis", "center", "scale", "score", "image_id",
              "perceptual_loss"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["n_valid"] == ref["n_valid"] == n_valid


def test_device_warp_batch_matches_jax_two_pass(coco):
    """Canvas 256 (a multiple of 128): the port takes K4. Labels and
    metadata against JAX's pipeline; crops against ``affine_warp_pallas``
    of the JAX pipeline's own canvases, normalised as its finalize does,
    within 1e-3 on the 0-255 scale."""
    k4 = _k4.warp_two_pass
    calls = []
    _k4.warp_two_pass = lambda *a: calls.append(1) or k4(*a)
    try:
        ref, raw, got = _batches(coco, 256)
    finally:
        _k4.warp_two_pass = k4
    assert calls == [1]
    rots = np.float32([s[3] for s in raw])
    assert (rots != 0).any()
    _check_labels(ref, got)
    crops = _pallas(np.stack([s[0] for s in raw]).astype(np.float32),
                    np.stack([s[1] for s in raw]),
                    np.stack([s[2] for s in raw]), rots, op_by_op=True)
    x = (crops / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(got["image"].numpy(), x,
                               atol=1e-3 / 255 / IMAGENET_STD.min(), rtol=0)


def test_device_warp_batch_matches_jax_direct(coco):
    """Canvas 200 (not a multiple of 128): the port takes K2, as JAX's
    pipeline does here, and the whole batch matches it."""
    k2 = _k2.affine_crop
    calls = []
    _k2.affine_crop = lambda *a: calls.append(1) or k2(*a)
    try:
        ref, _, got = _batches(coco, 200)
    finally:
        _k2.affine_crop = k2
    assert calls == [1]
    _check_labels(ref, got)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]),
                               atol=1e-3 / 255 / IMAGENET_STD.min(), rtol=0)


@pytest.mark.parametrize("opts,n_valid", [
    (dict(pad_multiple=B), [B, 2]),
    (dict(drop_last=True), [B]),
])
def test_device_warp_epoch_options_match_jax(coco, opts, n_valid):
    """A shuffled, augmented epoch of 6 records in batches of 4 (canvas
    200, K2 on both sides): padded to a multiple of 4 with repeated
    samples, or with the partial batch dropped. Every batch, its padding
    included, matches JAX's pipeline."""
    train_json, img_root = coco
    records = jax_records(train_json, img_root, is_train=True)
    port_records = load_coco_pose_records(train_json, img_root,
                                          is_train=True)
    assert len(records) == 6
    kw = dict(batch_size=B, is_train=True, exp_data=AUG, num_workers=1,
              seed=5, canvas_size=200, shuffle=True, **opts)
    with jax.disable_jit():
        ref = list(JaxPipeline(records, device_warp=True, **kw))
    got = list(PoseDataPipeline(port_records, device="cpu", **kw))
    assert len(got) == len(ref) == len(n_valid)
    for g, r, n in zip(got, ref, n_valid):
        assert g["image"].shape[0] == B
        _check_labels(r, g, n)
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(r["image"]),
                                   atol=1e-3 / 255 / IMAGENET_STD.min(),
                                   rtol=0)


def test_pipeline_defaults_to_the_card(monkeypatch):
    """The pipeline makes its batches on "cuda" unless told otherwise, and
    raises where there is no GPU instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseDataPipeline([], B, is_train=False)
    assert PoseDataPipeline([], B, is_train=False,
                            device="cpu").device.type == "cpu"
