"""Pose-vector processing and kNN database management.

Port of ``stlpose_tpu/retrieval/pose_db.py`` (host numpy, float64):
keypoint-subset selection (all/full/upper body), nose-centering for
translation invariance, optional L2 normalisation, HNSW graph
construction (M = 8, ef = 1000), the pickled graph_/data_/features_
artifacts, and neighbour search either through the index or by an
exhaustive metric scan with occlusion penalisation none / zero_coord /
mean / max. The scan is the JAX package's per-element loop, kept in its
order so that both give the same distances bit for bit.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from stlpose_tpu_torch.config import CONFIG
from stlpose_tpu_torch.retrieval.hnsw import Index
from stlpose_tpu_torch.retrieval.metrics import confidence_score, oks_score

APPROACHES = ("all_kpts", "full_body", "upper_body")


def keypoint_subset(approach: str) -> np.ndarray:
    """Keypoint index set per approach (lib/pose_database.py:34-44)."""
    if approach == "all_kpts":
        return np.arange(17)
    if approach == "full_body":
        return np.append(np.arange(5, 17), 0)
    if approach == "upper_body":
        return np.append(np.arange(5, 13), 0)
    raise ValueError(f"approach '{approach}' not in {APPROACHES}")


def process_pose_vector(vector, approach: str, normalize: bool = True):
    """(17, >=2) keypoints -> flat pose vector: subset, drop confidence,
    nose-center (zeros stay zero), optional L2 norm
    (lib/pose_database.py:19-69)."""
    vector = np.asarray(vector, np.float64)
    if vector.ndim > 1:
        v = vector[keypoint_subset(approach), 0:2].flatten()
    else:
        v = vector[keypoint_subset(approach)].astype(np.float64)
    zero = v == 0
    nose_x, nose_y = v[0], v[1]
    v[0::2] -= nose_x
    v[1::2] -= nose_y
    v[zero] = 0
    if normalize:
        n = np.linalg.norm(v)
        v = v / (n if n > 1e-5 else 1e-5)
    return v


def process_data(joints, approach: str, normalize: bool = True):
    """Batched variant over (N, 17, >=2) arrays (06_fit_knn_tree.py:84-147)."""
    joints = np.asarray(joints, np.float64)
    feats = joints[:, keypoint_subset(approach), 0:2].reshape(len(joints), -1)
    zero = feats == 0
    feats[:, 0::2] -= feats[:, 0:1]
    feats[:, 1::2] -= feats[:, 1:2]
    feats[zero] = 0
    if normalize:
        norms = np.linalg.norm(feats, axis=1, keepdims=True)
        norms[norms < 1e-5] = 1e-5
        feats = feats / norms
    return feats


def create_graph(features, metric: str = "euclidean_distance",
                 M: int = 8, ef: int = 1000) -> Index:
    """Fit the HNSW index with the reference's hyperparameters
    (06_fit_knn_tree.py:150-166)."""
    space = "l2" if metric == "euclidean_distance" else "cosine"
    n, dim = features.shape
    graph = Index(space=space, dim=dim)
    graph.init_index(max_elements=n, ef_construction=ef, M=M)
    graph.set_ef(ef)
    graph.add_items(np.asarray(features, np.float32), np.arange(n))
    return graph


# ------------------------------------------------------------ persistence
def database_path(db_name: str, db_split: str = "eval",
                  root: str | None = None) -> str:
    root = root or CONFIG["paths"]["database_path"]
    return os.path.join(root, f"database_{db_name}_{db_split}.pkl")


def save_database(database: dict, db_name: str, db_split: str = "eval",
                  root: str | None = None) -> str:
    path = database_path(db_name, db_split, root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(database, f)
    return path


def load_database(db_name: str, db_split: str = "eval",
                  root: str | None = None) -> dict:
    with open(database_path(db_name, db_split, root), "rb") as f:
        database = pickle.load(f)
    return database.get("data", database) if isinstance(database, dict) \
        else database


def save_knn_structure(graph: Index, features, database: dict,
                       name_mask: str, root: str | None = None):
    """Persist graph_/data_/features_ artifacts (06_fit_knn_tree.py:169-208)."""
    root = root or CONFIG["paths"]["knn_path"]
    os.makedirs(root, exist_ok=True)
    graph.save_index(os.path.join(root, f"graph_{name_mask}"))
    with open(os.path.join(root, f"data_{name_mask}"), "wb") as f:
        pickle.dump(database, f)
    with open(os.path.join(root, f"features_{name_mask}"), "wb") as f:
        pickle.dump(np.asarray(features), f)
    return root


def load_knn(database_file: str, root: str | None = None,
             space: str = "l2", ef: int = 1000):
    """Load (knn, database, features) by the data_ file name
    (lib/pose_database.py:99-146)."""
    root = root or CONFIG["paths"]["knn_path"]
    name_mask = database_file[5:] if database_file.startswith("data_") \
        else database_file
    with open(os.path.join(root, f"data_{name_mask}"), "rb") as f:
        database = pickle.load(f)
    with open(os.path.join(root, f"features_{name_mask}"), "rb") as f:
        features = pickle.load(f)
    knn = Index(space=space, dim=features.shape[-1])
    knn.load_index(os.path.join(root, f"graph_{name_mask}"))
    knn.set_ef(ef)
    return knn, database, features


# ----------------------------------------------------------------- search
def get_neighbors_idxs(query, num_retrievals: int = 10,
                       approach: str = "full_body",
                       retrieval_method: str = "knn",
                       penalization: str | None = None, **kwargs):
    """Retrieve nearest database poses for a query vector
    (lib/pose_database.py:149-248).

    retrieval_method: knn | euclidean_distance | cosine_similarity |
      manhattan_distance | confidence_score | oks_score.
    penalization (exhaustive methods only): None/"none" drops keypoints
    occluded in the query from both vectors; "zero_coord" keeps raw zeros;
    "mean"/"max" substitute the mean/max metric value for keypoints missing
    in the query but present in the database item.
    """
    query = np.asarray(query, np.float64)
    confidence = np.asarray(kwargs.get("scores", np.ones_like(query)),
                            np.float64)

    if retrieval_method == "knn":
        knn = kwargs["knn"]
        ids, dists = knn.knn_query(query.astype(np.float32),
                                   k=num_retrievals)
        return ids[0], dists[0]

    if retrieval_method == "cosine_similarity":
        metric = lambda q, v, c: 1.0 - float(np.dot(q, v))
    elif retrieval_method == "euclidean_distance":
        metric = lambda q, v, c: float(np.sqrt(((q - v) ** 2).sum()))
    elif retrieval_method == "manhattan_distance":
        metric = lambda q, v, c: float(np.abs(q - v).sum())
    elif retrieval_method == "confidence_score":
        metric = confidence_score
    elif retrieval_method == "oks_score":
        confidence = np.ones_like(query)
        metric = lambda q, v, c: oks_score(q, v, approach)
    else:
        raise ValueError(
            f"Retrieval metric '{retrieval_method}' is not defined")

    database = np.asarray(kwargs["database"], np.float64)
    eps = 1e-5

    pen_value = None
    if penalization in ("mean", "max"):
        sample = database[:min(100, len(database))]
        vals = [metric(query, v, confidence) for v in sample]
        pen_value = float(np.mean(vals) if penalization == "mean"
                          else np.max(vals))

    dists = []
    for pose_vect in database:
        if penalization == "zero_coord":
            # occluded keypoints keep their raw (0, 0) coordinates
            q, v, c = query, pose_vect, confidence
        elif penalization in (None, "none"):
            # drop keypoints occluded in the query from both vectors
            q, v, c = query.copy(), pose_vect.copy(), confidence.copy()
            occ = np.abs(query) < eps
            q[occ], v[occ], c[occ] = 0, 0, 0
        else:  # mean / max substitution
            q, v, c = query.copy(), pose_vect.copy(), confidence.copy()
            occ = (np.abs(query) < eps) & (np.abs(pose_vect) > eps)
            q[occ] = pen_value
            v[occ], c[occ] = 0, 0
        dists.append(metric(q, v, c))

    idx = np.argsort(dists)[:num_retrievals]
    return idx, [dists[i] for i in idx]
