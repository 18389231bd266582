"""The port's retrieval core (stlpose_tpu_torch/retrieval: metrics, pose
vectors, exhaustive neighbour search, the native HNSW index and the kNN
artifacts) against the JAX package's, on the same seeded numpy inputs.

- Metrics: ``score_retrievals`` dicts equal (the -1 sentinel case too);
  ``confidence_score`` and ``oks_score`` within 1e-12 at the three
  vector lengths (26, 34, 18) that choose the OKS sigma subset.
- Pose vectors: ``process_pose_vector`` and ``process_data`` bit for bit
  on joints with planted zero keypoints and a zero nose.
- ``get_neighbors_idxs``: every exhaustive method with every penalisation,
  indices equal and distances within 1e-12.
- HNSW: both packages compile the same ``hnsw.cpp`` with the same flags
  (the level generator is seeded, the build single-threaded), so on one
  machine they build the same graph: equal ids and distances, saved
  files byte-identical, each package loading the other's file. The port's
  library is built once per module.
- The port raises when its build fails, where the JAX package falls back
  to a numpy search.
"""

import contextlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from stlpose_tpu.retrieval import hnsw as jax_hnsw
from stlpose_tpu.retrieval import metrics as jax_metrics
from stlpose_tpu.retrieval import pose_db as jax_pose_db
from stlpose_tpu_torch.retrieval import hnsw, metrics, pose_db

METHODS = ("euclidean_distance", "cosine_similarity", "manhattan_distance",
           "confidence_score", "oks_score")
PENALIZATIONS = ("none", "zero_coord", "mean", "max")


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


@pytest.mark.parametrize("penalization", PENALIZATIONS)
@pytest.mark.parametrize("method", METHODS)
def test_exhaustive_search_equal(method, penalization):
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
