#!/usr/bin/env python
"""Quantitative pose-retrieval evaluation.

    python stlpose_tpu_torch/scripts/07_retrieval_experiments.py
        -d OUT_DIR --database_file data_*.pkl [--retrieval_method knn|...]
        [--approach full_body] [--penalization none|zero_coord|mean|max]
        [--normalize True] [--num_retrievals -1] [--knn_path DIR]
        [--dict_path DIR]

Counterpart of ``scripts/07_retrieval_experiments.py``: every database
pose queries the index (or the exhaustive scan); character- and
narrative-level P@k / mAP / R@k / mAR, grouped per label and overall,
saved as ``retrieval_results_*.json`` in OUT_DIR. Host code.
"""

import argparse
import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.retrieval_db import RetrievalExperimenter  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--exp_directory", required=True,
                   help="directory where result JSONs are written")
    p.add_argument("--database_file", required=True,
                   help="data_* artifact name from 06_fit_knn_tree")
    p.add_argument("--retrieval_method", default="knn",
                   choices=["knn", "euclidean_distance", "cosine_similarity",
                            "manhattan_distance", "confidence_score",
                            "oks_score"])
    p.add_argument("--approach", default="full_body",
                   choices=["all_kpts", "full_body", "upper_body"])
    p.add_argument("--penalization", default="none",
                   choices=["none", "zero_coord", "mean", "max"])
    p.add_argument("--normalize", default="True")
    p.add_argument("--num_retrievals", type=int, default=-1)
    p.add_argument("--knn_path", default=None)
    p.add_argument("--dict_path", default=None)
    args = p.parse_args(argv)

    exp = RetrievalExperimenter(
        args.exp_directory, args.database_file,
        retrieval_method=args.retrieval_method, approach=args.approach,
        penalization=args.penalization, normalize=args.normalize == "True",
        num_retrievals=args.num_retrievals, knn_root=args.knn_path,
        dict_path=args.dict_path)
    exp.setup()
    exp.retrieval_experiment()
    results = {level: exp.process_retrieval_results(level)
               for level in ("character", "narrative")}
    print(f"Retrieval over {exp.n_entries} poses took "
          f"{exp.elapsed_time:.2f}s")
    return results


if __name__ == "__main__":
    main()
