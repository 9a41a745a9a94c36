"""Pack scene records into memmap training rows
(``catgrasp_tpu/pipelines/pack_training_data.py``; host numpy, no device).

One pass over a split's scene files writes the fixed-shape binary rows of
``data/packed.py`` that the trainers memmap, with the grasp labels
projected from the per-instance balanced grasp DBs
(``dataset/grasps/<class>_train_*_balanced_grasp.npz``, matched by
``shape_id``).

    python -m catgrasp_tpu_torch.pipelines.pack_training_data --class_name nut \\
        --split train
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data import packed
from ..utils.outputs import refuse_tracked
from .generate_pile_data import DEFAULT_OUT_DIR, default_out_dir


def default_packed_dir(class_name: str, split: str) -> str:
    return f"{DEFAULT_OUT_DIR}/{class_name}/packed_{split}"


def load_grasp_dbs(class_name: str, split: str = "train", db_dir: str = "dataset/grasps"):
    """Per-instance balanced grasp DBs, each with its ``shape_id``."""
    dbs = []
    for f in sorted(glob.glob(os.path.join(db_dir, f"{class_name}_{split}_*_balanced_grasp.npz"))):
        db = dict(np.load(f, allow_pickle=True))
        db["shape_id"] = int(db["index"])
        dbs.append(db)
    return dbs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--split", default="train")
    ap.add_argument("--root", default=None, help=f"default {DEFAULT_OUT_DIR}/<class>/<split>")
    ap.add_argument("--out_dir", default=None,
                    help=f"default {DEFAULT_OUT_DIR}/<class>/packed_<split>")
    ap.add_argument("--db_dir", default="dataset/grasps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    root = args.root or default_out_dir(args.class_name, args.split)
    out = args.out_dir or default_packed_dir(args.class_name, args.split)
    refuse_tracked(out)
    dbs = load_grasp_dbs(args.class_name, db_dir=args.db_dir)
    print(f"packing {root} -> {out} ({len(dbs)} grasp DBs)")
    meta = packed.pack_split(root, out, grasp_db=dbs, seed=args.seed)
    print(meta)
    return meta


if __name__ == "__main__":
    main()
