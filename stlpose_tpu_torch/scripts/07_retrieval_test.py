#!/usr/bin/env python
"""Qualitative retrieval demo: sample queries, retrieve the top k, draw
the query and the retrieved skeletons.

    python stlpose_tpu_torch/scripts/07_retrieval_test.py
        --database_file data_*.pkl [--num_queries 5] [--num_retrievals 5]
        [--approach full_body] [--normalize True] [--knn_path DIR]
        [--output_dir retrieval_test_plots]

Counterpart of ``scripts/07_retrieval_test.py``: the queries are drawn
with ``RandomState(13)`` as there, one PNG per query
(``retrieval_query_{i}.png``). Needs matplotlib, imported inside
``main``.
"""

import argparse
import os
import sys

import numpy as np

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch import constants  # noqa: E402
from stlpose_tpu_torch.retrieval import (get_neighbors_idxs, load_knn,  # noqa: E402
                                         process_pose_vector)
from stlpose_tpu_torch.utils.visualization import draw_pose  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--database_file", required=True)
    p.add_argument("--num_queries", type=int, default=5)
    p.add_argument("--num_retrievals", type=int, default=5)
    p.add_argument("--approach", default="full_body")
    p.add_argument("--normalize", default="True")
    p.add_argument("--knn_path", default=None)
    p.add_argument("--output_dir", default="retrieval_test_plots")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    knn, database, features = load_knn(args.database_file,
                                       root=args.knn_path)
    keys = list(database.keys())
    rng = np.random.RandomState(13)
    os.makedirs(args.output_dir, exist_ok=True)

    written = []
    for qi in rng.choice(len(keys), min(args.num_queries, len(keys)),
                         replace=False):
        query = database[keys[qi]]
        vec = process_pose_vector(np.asarray(query["joints"]),
                                  args.approach,
                                  args.normalize == "True")
        idx, dists = get_neighbors_idxs(
            vec, num_retrievals=args.num_retrievals + 1, knn=knn,
            approach=args.approach, retrieval_method="knn",
            database=features)
        fig, axes = plt.subplots(1, args.num_retrievals + 1,
                                 figsize=(3 * (args.num_retrievals + 1), 4))
        canvas = np.ones((256, 192, 3), np.float32)
        draw_pose(canvas, np.asarray(query["joints"]),
                  skeleton=constants.SKELETON_SIMPLE, ax=axes[0],
                  title=f"query: {query['character_name']}")
        for rank, j in enumerate(idx[1:args.num_retrievals + 1], start=1):
            r = database[keys[int(j)]]
            draw_pose(canvas, np.asarray(r["joints"]),
                      skeleton=constants.SKELETON_SIMPLE, ax=axes[rank],
                      title=f"#{rank}: {r['character_name']}")
        out = os.path.join(args.output_dir, f"retrieval_query_{qi}.png")
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
        print(f"Saved {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
