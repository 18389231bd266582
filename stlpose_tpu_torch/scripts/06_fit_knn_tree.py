#!/usr/bin/env python
"""Preprocess pose vectors and fit the HNSW kNN index.

    python stlpose_tpu_torch/scripts/06_fit_knn_tree.py
        --database_file database_*.pkl
        [--metric euclidean_distance|cosine_similarity]
        [--approach all_kpts|full_body|upper_body] [--normalize True]
        [--database_path DIR] [--knn_path DIR]

Counterpart of ``scripts/06_fit_knn_tree.py``: keypoint subset,
nose-centering, optional L2 normalisation, the HNSW index (M = 8,
ef = 1000; ``native/hnsw.cpp``, built with g++ at first use) and the
pickled graph_/data_/features_ artifacts under the knn root. Host code.
"""

import argparse
import os
import pickle
import sys

import numpy as np

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.config import CONFIG  # noqa: E402
from stlpose_tpu_torch.retrieval import (create_graph, process_data,  # noqa: E402
                                         save_knn_structure)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--database_file", required=True,
                   help="pose database pickle (database_*.pkl)")
    p.add_argument("--metric", default="euclidean_distance",
                   choices=["euclidean_distance", "cosine_similarity"])
    p.add_argument("--approach", default="full_body",
                   choices=["all_kpts", "full_body", "upper_body"])
    p.add_argument("--normalize", default="True")
    p.add_argument("--database_path", default=None)
    p.add_argument("--knn_path", default=None)
    args = p.parse_args(argv)
    args.normalize = args.normalize == "True"

    db_root = args.database_path or CONFIG["paths"]["database_path"]
    db_file = args.database_file if os.path.isabs(args.database_file) \
        else os.path.join(db_root, args.database_file)
    assert os.path.exists(db_file), f"database '{db_file}' not found"

    with open(db_file, "rb") as f:
        database = pickle.load(f)
    data = database.get("data", database)
    joints = np.array([np.asarray(data[k]["joints"]) for k in data])

    features = process_data(joints, args.approach, args.normalize)
    print(f"Processing {len(features)} pose vectors of dimensionality "
          f"{features.shape[-1]}")
    graph = create_graph(features, args.metric)

    approach = "" if args.approach == "full_body" \
        else f"approach_{args.approach}_"
    name = (f"{os.path.basename(db_file)[:-4]}_metric_{args.metric}_"
            f"norm_{approach}{args.normalize}.pkl")
    root = save_knn_structure(graph, features, data, name,
                              root=args.knn_path)
    print(f"Saved kNN artifacts 'graph_/data_/features_{name}' under {root}")
    return name


if __name__ == "__main__":
    main()
