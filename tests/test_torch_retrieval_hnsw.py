"""The port's native HNSW index (stlpose_tpu_torch/retrieval/hnsw.py, the
ctypes binding of native/hnsw.cpp) and the kNN artifacts of
retrieval/pose_db.py against the JAX package's. Both packages compile the
same ``hnsw.cpp`` with the same flags (the level generator is seeded, the
build single-threaded), so on one machine they build the same graph:
equal ids and distances, saved files byte-identical, each package loading
the other's file. The port's library is built once per module. Split from
tests/test_torch_retrieval.py so that each test file of the port holds
at most 12 tests (pytest-xdist's ``--dist loadfile`` queues files
largest first).
"""

import contextlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from stlpose_tpu.retrieval import hnsw as jax_hnsw
from stlpose_tpu.retrieval import pose_db as jax_pose_db
from stlpose_tpu_torch.retrieval import hnsw, pose_db
from tests.test_torch_retrieval import planted_joints


@contextlib.contextmanager
def jax_hnsw_built_in(lib_dir):
    """The JAX package's HNSW library built by its own Makefile from its
    own source in ``lib_dir`` and bound by its own ``_load_lib``, for the
    duration: no other test process building ``stlpose_tpu/native`` at the
    same time can hand this one a partial file."""
    native = os.path.join(os.path.dirname(jax_hnsw.__file__), "..",
                          "native")
    for name in ("Makefile", "hnsw.cpp"):
        shutil.copy(os.path.join(native, name), os.path.join(lib_dir, name))
    subprocess.run(["make", "-C", str(lib_dir)], check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hnsw, "_SO_PATH",
                   os.path.join(lib_dir, "libstlpose_hnsw.so"))
        mp.setattr(jax_hnsw, "_LIB", None)
        assert jax_hnsw.native_available()
        yield


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library, built (or found) once for the module, and the
    JAX package's (``jax_hnsw_built_in``)."""
    path = hnsw.build()
    with jax_hnsw_built_in(tmp_path_factory.mktemp("jax_native")):
        yield path


def build_pair(space, data):
    """The same data through the port's index and the JAX package's."""
    out = []
    for mod in (hnsw, jax_hnsw):
        idx = mod.Index(space, data.shape[1])
        idx.init_index(len(data), ef_construction=200, M=8)
        idx.set_ef(200)
        idx.add_items(data, np.arange(len(data)))
        out.append(idx)
    return out


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(13)
    return rng.randn(1500, 26).astype(np.float32)


@pytest.mark.parametrize("space", ["l2", "cosine"])
def test_hnsw_matches_jax_index(built, corpus, space):
    port, ref = build_pair(space, corpus)
    assert port.get_current_count() == ref.get_current_count() == 1500
    q = corpus[::37] + 0.01
    ids, dists = port.knn_query(q, k=10)
    ref_ids, ref_dists = ref.knn_query(q, k=10)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(dists, ref_dists)
    # and the index finds what the exact search finds
    exact, _ = hnsw.exact_knn(corpus, q, 10, space)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(ids.tolist(), exact.tolist())])
    assert recall > 0.95, recall


@pytest.mark.parametrize("space", ["l2", "cosine"])
def test_hnsw_files_identical_and_cross_load(built, corpus, space, tmp_path):
    port, ref = build_pair(space, corpus)
    p_port, p_ref = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    port.save_index(p_port)
    ref.save_index(p_ref)
    with open(p_port, "rb") as f, open(p_ref, "rb") as g:
        assert f.read() == g.read()
    q = corpus[:20]
    want, want_d = port.knn_query(q, k=5)
    for mod, path in ((hnsw, p_ref), (jax_hnsw, p_port)):
        other = mod.Index(space, corpus.shape[1])
        other.load_index(path)
        other.set_ef(200)
        got, got_d = other.knn_query(q, k=5)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_d, want_d)


def test_loads_the_jax_numpy_backend_index(built, corpus, tmp_path):
    """An index the JAX package saved from its numpy backend (an .npz of
    data and labels) is read by the port and searched exactly."""
    ref = jax_hnsw.Index("l2", 26)
    ref._lib = None
    ref.init_index(1500)
    ref.add_items(corpus[:300], np.arange(300) + 7)
    path = str(tmp_path / "graph_np")
    ref.save_index(path)
    port = hnsw.Index("l2", 26)
    port.load_index(path)
    assert port.get_current_count() == 300
    ids, dists = port.knn_query(corpus[:4], k=3)
    ref_ids, ref_dists = ref.knn_query(corpus[:4], k=3)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(dists, ref_dists)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_knn_artifacts_across_packages(built, writer, tmp_path):
    rng = np.random.RandomState(5)
    joints = planted_joints(rng, 40)
    db = {f"img_{i}": {"img": f"{i}.jpg", "joints": j,
                       "character_name": "ab"[i % 2]}
          for i, j in enumerate(joints)}
    w, r = (pose_db, jax_pose_db) if writer == "port" else \
        (jax_pose_db, pose_db)
    feats = w.process_data(joints, "full_body", True)
    name = "database_x_eval_metric_euclidean_distance_norm_True.pkl"
    w.save_knn_structure(w.create_graph(feats), feats, db, name,
                         root=str(tmp_path))
    knn, database, features = r.load_knn("data_" + name,
                                         root=str(tmp_path))
    np.testing.assert_array_equal(features, feats)
    assert list(database) == list(db)
    ids, _ = knn.knn_query(feats.astype(np.float32), k=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(40))


@pytest.mark.parametrize("call", ["data width", "label count", "query width",
                                  "space"])
def test_index_refuses_bad_shapes(built, call):
    """Shapes are checked before any pointer reaches the library (the C
    side reads n x dim floats and n labels)."""
    idx = hnsw.Index("l2", 4)
    idx.init_index(8)
    bad = {"data width": lambda: idx.add_items(np.zeros((3, 5))),
           "label count": lambda: idx.add_items(np.zeros((3, 4)), [1, 2]),
           "query width": lambda: idx.knn_query(np.zeros((2, 3))),
           "space": lambda: hnsw.Index("ip", 4)}[call]
    with pytest.raises(ValueError):
        bad()
    assert idx.get_current_count() == 0
