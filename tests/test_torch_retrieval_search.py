"""``retrieval/pose_db.py::get_neighbors_idxs`` of the port against the
JAX package's: the distance methods (euclidean, cosine, manhattan) with
every penalisation, indices equal and distances within 1e-12 (the score
methods are in tests/test_torch_retrieval_search_scores.py). Split from
tests/test_torch_retrieval.py so that each test file of the port holds
at most 12 tests (pytest-xdist's ``--dist loadfile`` queues files
largest first).
"""

import numpy as np
import pytest

from stlpose_tpu.retrieval import pose_db as jax_pose_db
from stlpose_tpu_torch.retrieval import pose_db
from tests.test_torch_retrieval import planted_joints

PENALIZATIONS = ("none", "zero_coord", "mean", "max")


def exhaustive_search_equal(method, penalization):
    """The port's exhaustive search against the JAX package's on 48
    planted poses, two queries (one with a zero nose)."""
    rng = np.random.RandomState(2)
    db = pose_db.process_data(planted_joints(rng, 48), "full_body", True)
    scores = rng.rand(db.shape[1])
    for query in (db[3], db[4]):          # db[4] has a zero nose
        kw = dict(num_retrievals=10, approach="full_body",
                  retrieval_method=method, penalization=penalization,
                  database=db, scores=scores)
        idx, dists = pose_db.get_neighbors_idxs(query, **kw)
        ref_idx, ref_dists = jax_pose_db.get_neighbors_idxs(query, **kw)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_allclose(dists, ref_dists, rtol=0, atol=1e-12)


@pytest.mark.parametrize("penalization", PENALIZATIONS)
@pytest.mark.parametrize("method", ["euclidean_distance", "cosine_similarity",
                                    "manhattan_distance"])
def test_exhaustive_search_equal(method, penalization):
    exhaustive_search_equal(method, penalization)
