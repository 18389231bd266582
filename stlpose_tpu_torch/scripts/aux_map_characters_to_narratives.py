#!/usr/bin/env python
"""Write the character -> narrative maps that the retrieval metrics read.

    python stlpose_tpu_torch/scripts/aux_map_characters_to_narratives.py
        (--narratives_json FILE | --database_file DB.pkl) [--dict_path DIR]

Counterpart of ``scripts/aux_map_characters_to_narratives.py``:
``char_narrative_map.json`` and ``narrative_char_map.json`` under the
mapping-dicts root (``--dict_path``, else ``CONFIG["paths"]["dict_path"]``).
The narratives come from a JSON of {narrative: [character, ...]}, or from a
retrieval database, each character its own narrative.
"""

import argparse
import json
import os
import pickle
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from stlpose_tpu_torch.config import CONFIG  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--narratives_json", default=None,
                   help="JSON of {narrative: [character, ...]}")
    p.add_argument("--database_file", default=None,
                   help="retrieval DB pickle to enumerate characters from")
    p.add_argument("--dict_path", default=None)
    args = p.parse_args(argv)

    dict_path = args.dict_path or CONFIG["paths"]["dict_path"]
    os.makedirs(dict_path, exist_ok=True)

    if args.narratives_json:
        with open(args.narratives_json) as f:
            narr_to_char = json.load(f)
    elif args.database_file:
        with open(args.database_file, "rb") as f:
            db = pickle.load(f)
        db = db.get("data", db)
        chars = sorted({v["character_name"] for v in db.values()})
        narr_to_char = {c: [c] for c in chars}
    else:
        raise SystemExit("Provide --narratives_json or --database_file")

    char_to_narr = {c: n for n, cs in narr_to_char.items() for c in cs}
    with open(os.path.join(dict_path, "char_narrative_map.json"), "w") as f:
        json.dump(char_to_narr, f, indent=2)
    with open(os.path.join(dict_path, "narrative_char_map.json"), "w") as f:
        json.dump(narr_to_char, f, indent=2)
    print(f"Wrote narrative maps for {len(char_to_narr)} characters to "
          f"{dict_path}")
    return char_to_narr, narr_to_char


if __name__ == "__main__":
    main()
