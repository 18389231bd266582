#!/usr/bin/env python
"""Build the pose retrieval database from ClassArch artworks.

    python stlpose_tpu_torch/scripts/05_create_archdata_retrieval_db.py
        -d EXP [--checkpoint N|final] [--dataset_name arch_data]
        [--data_path DIR] [--device cuda|cpu]

Counterpart of ``scripts/05_create_archdata_retrieval_db.py``:
``ArchDataExtractor`` over the experiment's eval split (flip-TTA HRNet
forward and K1's peaks on the device, joints in the 256x192 crop frame),
saved as ``<database root>/database_{dataset}_{experiment}_eval.pkl``.
Environment: ``STLPOSE_MODEL_CONFIG`` (default w32_256x192),
``STLPOSE_PRETRAINED`` (a reference-format HRNet ``.pth``; none by
default), ``STLPOSE_DTYPE=bfloat16`` for bf16 compute and
``STLPOSE_DATABASE_PATH`` for the database root.
"""

import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.engines.retrieval_db import ArchDataExtractor  # noqa: E402
from stlpose_tpu_torch.utils.arguments import (get_directory_argument,  # noqa: E402
                                               model_dtype)
from stlpose_tpu_torch.utils.logger import Logger, print_  # noqa: E402


def main(argv=None):
    exp_path, args = get_directory_argument(argv, get_checkpoint=True,
                                            get_dataset=True)
    Logger(exp_path)
    print_("Extracting retrieval database", type="new_exp")
    extractor = ArchDataExtractor(
        exp_path, checkpoint=args.checkpoint,
        dataset_name=args.dataset_name or "arch_data",
        data_path=args.data_path, dtype=model_dtype(), device=args.device)
    extractor.setup(
        config_name=os.environ.get("STLPOSE_MODEL_CONFIG", "w32_256x192"),
        pretrained=os.environ.get("STLPOSE_PRETRAINED") or None)
    extractor.extract_retrieval_dataset()
    path = extractor.save_retrieval_db()
    print_(f"Saved retrieval database with {len(extractor.retrieval_db)} "
           f"poses to {path}")
    return path


if __name__ == "__main__":
    main()
