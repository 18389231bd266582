"""``retrieval/pose_db.py::get_neighbors_idxs`` of the port against the
JAX package's: the score methods (confidence score, OKS) with every
penalisation, indices equal and distances within 1e-12 (the distance
methods are in tests/test_torch_retrieval_search.py). Split from
tests/test_torch_retrieval.py so that each test file of the port holds
at most 12 tests (pytest-xdist's ``--dist loadfile`` queues files
largest first).
"""

import pytest

from tests.test_torch_retrieval_search import (PENALIZATIONS,
                                               exhaustive_search_equal)


@pytest.mark.parametrize("penalization", PENALIZATIONS)
@pytest.mark.parametrize("method", ["confidence_score", "oks_score"])
def test_exhaustive_search_equal(method, penalization):
    exhaustive_search_equal(method, penalization)
