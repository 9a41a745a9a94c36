"""Re-score a subsample of a stored grasp DB under the port's physics: the
drift probe of ``scripts/rescore_grasp_db.py`` (its ``--write`` mode is not
ported).  The same candidates go through ``perturbation_scores``; the row
compares the fresh scores with the stored ones.

    python -m catgrasp_tpu_torch.pipelines.rescore_grasp_db \\
        --db dataset/grasps/nut_train_*_complete_grasp.npz --n 256 --trials 50

Scores are ``trials``-sample Monte Carlo estimates, so two seeds of the
same physics agree only up to sampling noise (about 0.07 at 50 trials).
"""
from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch

from ..device import resolve_device, sync
from ..geom import csg as csglib
from ..geom import primitives as prim
from ..grasp.gripper import Gripper
from ..sim import env_grasp as eg
from ..sim.types import build_shape_lib


def rescore(db_path: str, n: int | None = 256, trials: int = 50, seed: int = 1234,
            score_chunk: int = 256, device=None):
    """(the DB, the subsample's indices, its stored scores, its fresh scores,
    the scoring wall seconds).  The subsample is numpy's
    ``default_rng(0).choice(len, n, replace=False)``, as the JAX probe
    draws it."""
    dev = resolve_device(device)
    d = dict(np.load(db_path, allow_pickle=True))
    cls = str(d["class_name"])
    split = str(d.get("split", "train"))
    index = int(d.get("index", re.search(r"_(\d+)_complete", db_path).group(1)))
    poses = np.asarray(d["grasp_poses"], np.float32)
    ids = np.arange(len(poses))
    if n is not None and n < len(poses):
        ids = np.random.default_rng(0).choice(len(poses), n, replace=False)
    sel = torch.from_numpy(poses[ids]).to(dev)
    lib = build_shape_lib([prim.make_instance(cls, split, index)],
                          [csglib.make_csg_instance(cls, split, index)], n_surf=64, seed=0,
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = Gripper.default().spec
    sync(dev)
    t0 = time.perf_counter()
    fresh = torch.cat([eg.perturbation_scores(gen, lib, 0, 1.0, sel[i:i + score_chunk],
                                              trials=trials, spec=spec)
                       for i in range(0, len(sel), score_chunk)]).cpu().numpy()
    return d, ids, np.asarray(d["scores"], np.float32)[ids], fresh, time.perf_counter() - t0


def spearman_np(a, b) -> float:
    """Spearman's rank correlation with ties ranked by argsort order."""
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    den = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / den) if den > 0 else 0.0


def drift_row(db_path: str, stored: np.ndarray, fresh: np.ndarray, trials: int,
              wall_s: float) -> dict:
    """The probe's comparison of fresh with stored scores."""
    q = len(fresh) // 4
    return {
        "db": db_path, "n": int(len(fresh)), "trials": trials,
        "stored_mean": float(stored.mean()), "fresh_mean": float(fresh.mean()),
        "spearman": spearman_np(stored, fresh),
        "mean_abs_diff": float(np.abs(stored - fresh).mean()),
        "top_quartile_overlap": float(np.isin(np.argsort(fresh)[-q:],
                                              np.argsort(stored)[-q:]).mean()),
        "wall_s": wall_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", required=True, nargs="+")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    for db_path in args.db:
        _, _, stored, fresh, wall = rescore(db_path, args.n, args.trials, args.seed,
                                            device=args.device)
        print(json.dumps(drift_row(db_path, stored, fresh, args.trials, wall)), flush=True)


if __name__ == "__main__":
    main()
