"""The port's retrieval core (stlpose_tpu_torch/retrieval: metrics, pose
vectors, the native HNSW library's build) against the JAX package's, on
the same seeded numpy inputs. The exhaustive neighbour search is in
tests/test_torch_retrieval_search*.py, the HNSW index and the kNN
artifacts in tests/test_torch_retrieval_hnsw.py.

- Metrics: ``score_retrievals`` dicts equal (the -1 sentinel case too);
  ``confidence_score`` and ``oks_score`` within 1e-12 at the three
  vector lengths (26, 34, 18) that choose the OKS sigma subset.
- Pose vectors: ``process_pose_vector`` and ``process_data`` bit for bit
  on joints with planted zero keypoints and a zero nose.
- The port raises when its build fails, where the JAX package falls back
  to a numpy search.
"""

import os

import numpy as np
import pytest

from stlpose_tpu.retrieval import metrics as jax_metrics
from stlpose_tpu.retrieval import pose_db as jax_pose_db
from stlpose_tpu_torch.retrieval import hnsw, metrics, pose_db


def planted_joints(rng, n):
    """(n, 17, 3) joints in a 192x256 frame with planted zero keypoints
    (whole keypoints and single coordinates) and, in every fourth pose, a
    zero nose."""
    joints = np.concatenate([rng.uniform(1, 191, (n, 17, 1)),
                             rng.uniform(1, 255, (n, 17, 1)),
                             rng.randint(0, 2, (n, 17, 1))], -1)
    drop = rng.rand(n, 17) < 0.15
    joints[drop, :2] = 0
    joints[rng.rand(n, 17) < 0.05, 0] = 0
    joints[::4, 0, :2] = 0
    return joints


def test_score_retrievals_equal():
    rng = np.random.RandomState(0)
    labels = ["a", "b", "c", "d"]
    cases = [("a", ["a"] + list(rng.choice(labels, 30))) for _ in range(4)]
    cases += [("z", ["z", "a", "b", "c"]),          # sentinel
              ("a", ["a", "a", "b"]),               # shorter than 5 and 10
              ("b", ["b"] + ["b"] * 12)]
    for label, ranked in cases:
        assert metrics.score_retrievals(label, ranked) == \
            jax_metrics.score_retrievals(label, ranked)


@pytest.mark.parametrize("dim", [26, 34, 18])
def test_confidence_and_oks_scores(dim):
    rng = np.random.RandomState(dim)
    for _ in range(5):
        q, v = rng.randn(dim), rng.randn(dim)
        c = rng.rand(dim)
        assert abs(metrics.confidence_score(q, v, c) -
                   jax_metrics.confidence_score(q, v, c)) <= 1e-12
        for approach in ("all_kpts", "full_body", "upper_body"):
            assert abs(metrics.oks_score(q, v, approach) -
                       jax_metrics.oks_score(q, v, approach)) <= 1e-12


@pytest.mark.parametrize("approach", ["all_kpts", "full_body", "upper_body"])
def test_pose_vectors_bit_equal(approach):
    joints = planted_joints(np.random.RandomState(1), 16)
    for normalize in (True, False):
        batch = pose_db.process_data(joints, approach, normalize)
        np.testing.assert_array_equal(
            batch, jax_pose_db.process_data(joints, approach, normalize))
        for j in joints:
            np.testing.assert_array_equal(
                pose_db.process_pose_vector(j, approach, normalize),
                jax_pose_db.process_pose_vector(j, approach, normalize))
    # a flat vector takes the subset of its entries
    flat = joints[0, :, 0]
    np.testing.assert_array_equal(
        pose_db.process_pose_vector(flat, approach, False),
        jax_pose_db.process_pose_vector(flat, approach, False))


@pytest.mark.parametrize("fault", ["no compiler", "compile error"])
def test_build_failure_raises(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(hnsw, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(hnsw, "_LIB", None)
    if fault == "no compiler":
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "not found"
    else:
        bad = tmp_path / "hnsw.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(hnsw, "_SRC", str(bad))
        match = "failed"
    with pytest.raises(RuntimeError, match=match):
        hnsw.Index("l2", 4)
    assert not os.path.exists(hnsw.library_path())
