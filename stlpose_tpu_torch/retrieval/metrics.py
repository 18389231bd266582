"""Retrieval quality and pose-similarity metrics.

Port of ``stlpose_tpu/retrieval/metrics.py`` (host numpy, float64, the
same operations in the same order): P@k / mAP / R@k / mAR with the
self-retrieval dropped and a -1 sentinel for labels with no other
relevant item; the confidence-weighted distance; the OKS-based pose
distance with its sigma subset chosen by the vector's length.
"""

from __future__ import annotations

import numpy as np

from stlpose_tpu_torch import constants


def score_retrievals(label, retrievals):
    """Precision/recall metrics for one ranked retrieval list
    (lib/metrics.py:25-90). ``retrievals[0]`` is the self-retrieval and is
    dropped; returns -1 sentinels when no other item shares the label."""
    retrievals = list(retrievals)[1:]
    relevant = np.array([1 if r == label else 0 for r in retrievals])
    n_rel = int(relevant.sum())
    if n_rel == 0:
        return {"label": label, "p@1": -1, "p@5": -1, "p@10": -1,
                "p@rel": -1, "mAP": -1, "r@1": -1, "r@5": -1, "r@10": -1,
                "r@rel": -1, "mAR": -1}

    ranks = np.arange(1, len(relevant) + 1)
    p_at = np.cumsum(relevant) / ranks
    r_at = np.cumsum(relevant) / n_rel

    def at(arr, k):
        return float(arr[k - 1]) if len(arr) >= k else float(arr[-1])

    return {
        "label": label,
        "p@1": at(p_at, 1), "p@5": at(p_at, 5), "p@10": at(p_at, 10),
        "p@rel": float(p_at[n_rel - 1]),
        "mAP": float((p_at * relevant).sum() / n_rel),
        "r@1": at(r_at, 1), "r@5": at(r_at, 5), "r@10": at(r_at, 10),
        "r@rel": float(r_at[n_rel - 1]),
        "mAR": float((r_at * relevant).sum() / n_rel),
    }


def confidence_score(query, pose_db, confidence):
    """Confidence-weighted pose distance (lib/metrics.py:97-115)."""
    query = np.asarray(query, np.float64)
    pose_db = np.asarray(pose_db, np.float64)
    confidence = np.asarray(confidence, np.float64)
    confidence = confidence / np.sqrt((confidence ** 2).sum())
    norm = 1.0 / confidence.sum()
    weighted = np.sqrt((confidence * (query - pose_db) ** 2).sum())
    return float(norm * weighted)


def oks_score(query, pose_db, approach):
    """OKS-based pose distance: 1 - mean per-keypoint Gaussian similarity
    (lib/metrics.py:118-149). Sigma subset keyed by the pose-vector length
    (26 -> shoulders..ankles+nose, 34 -> all, else shoulders..hips+nose)."""
    query = np.asarray(query, np.float64)
    pose_db = np.asarray(pose_db, np.float64)
    sigmas = np.asarray(constants.OKS_SIGMAS)
    if len(query) == 26:
        idx = np.append(np.arange(5, 17), 0)
    elif len(query) == 34:
        idx = np.arange(17)
    else:
        idx = np.append(np.arange(5, 13), 0)
    sig = sigmas[idx]
    dx = query[0::2] - pose_db[0::2]
    dy = query[1::2] - pose_db[1::2]
    e = (dx ** 2 + dy ** 2) / (2.0 * sig ** 2)
    oks = np.exp(-e).sum() / (len(query) // 2)
    return float(1.0 - oks)
