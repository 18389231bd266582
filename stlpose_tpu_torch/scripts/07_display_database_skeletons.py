#!/usr/bin/env python
"""Draw every stored database skeleton on a blank canvas.

    python stlpose_tpu_torch/scripts/07_display_database_skeletons.py
        --database_file database_{name}_eval.pkl|PATH
        [--database_path DIR] [--output_dir database_skeletons]
        [--limit 50]

Counterpart of ``scripts/07_display_database_skeletons.py``: one PNG per
entry (``{key}.png``), the first ``--limit``. Needs matplotlib, imported
inside ``main``.
"""

import argparse
import os
import pickle
import sys

import numpy as np

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch import constants  # noqa: E402
from stlpose_tpu_torch.retrieval import load_database  # noqa: E402
from stlpose_tpu_torch.utils.visualization import draw_pose  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--database_file", required=True,
                   help="database name (database_{name}_{split}.pkl) or path")
    p.add_argument("--database_path", default=None)
    p.add_argument("--output_dir", default="database_skeletons")
    p.add_argument("--limit", type=int, default=50)
    args = p.parse_args(argv)

    # headless, and missing matplotlib fails here, before the database
    # is read
    import matplotlib
    matplotlib.use("Agg")

    if os.path.isfile(args.database_file):
        with open(args.database_file, "rb") as f:
            db = pickle.load(f)
        db = db.get("data", db) if isinstance(db, dict) else db
    else:
        name = args.database_file
        name = name.replace("database_", "").replace("_eval.pkl", "")
        db = load_database(name, "eval", args.database_path)

    os.makedirs(args.output_dir, exist_ok=True)
    canvas = np.ones((256, 192, 3), np.float32)
    written = []
    for i, (key, item) in enumerate(db.items()):
        if i >= args.limit:
            break
        out = os.path.join(args.output_dir, f"{key}.png")
        draw_pose(canvas, np.asarray(item["joints"]),
                  skeleton=constants.SKELETON_SIMPLE,
                  title=item.get("character_name", ""), savepath=out)
        written.append(out)
    print(f"Rendered {min(len(db), args.limit)} skeletons to "
          f"{args.output_dir}")
    return written


if __name__ == "__main__":
    main()
