"""Re-score a stored grasp DB's perturbation scores under the port's physics
(``scripts/rescore_grasp_db.py`` in PyTorch).  The same candidates go
through ``perturbation_scores``; a JSON row compares the fresh scores with
the stored ones.

Drift probe (a subsample of ``--n`` poses):

    python -m catgrasp_tpu_torch.pipelines.rescore_grasp_db \\
        --db dataset/grasps/nut_train_*_complete_grasp.npz --n 256 --trials 50

Full re-score (``--write``: every pose; the DB with the fresh ``scores`` and
``score_version``, and with ``--rebalance`` its ``*_balanced_grasp.npz``):

    python -m catgrasp_tpu_torch.pipelines.rescore_grasp_db \\
        --db dataset/grasps/screw_train_0_complete_grasp.npz --write --rebalance

The JAX script rewrites its input in place; this one writes under
``--out_dir`` (default ``dataset/grasps_torch``) under the input's name, and
never into the tracked ``dataset/grasps``.  The row goes to stdout, and with
``--out`` it is appended to that JSONL file.

Scores are ``trials``-sample Monte Carlo estimates, so two seeds of the
same physics agree only up to sampling noise (about 0.07 at 50 trials);
``--noise_floor`` re-scores with another seed and reports that agreement.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from ..config.loader import load_config
from ..device import resolve_device, sync
from ..geom import csg as csglib
from ..geom import primitives as prim
from ..grasp.gripper import Gripper
from ..sim import env_grasp as eg
from ..sim.env_semantic import TRY_GRASP_VERSION
from ..sim.types import build_shape_lib
from ..utils.outputs import refuse_tracked
from .generate_grasp import DEFAULT_OUT_DIR, balance_score_bins


def rescore(db_path: str, n: int | None = 256, trials: int = 50, seed: int = 1234,
            score_chunk: int = 256, device=None):
    """(the DB, the subsample's indices, its stored scores, its fresh scores,
    the scoring wall seconds).  The subsample is numpy's
    ``default_rng(0).choice(len, n, replace=False)``, as the JAX probe
    draws it; ``n=None`` re-scores every pose."""
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
    """The probe's comparison of fresh with stored scores: the JAX script's
    row, rounded as it rounds it."""
    return {
        "db": db_path, "n": int(len(fresh)), "trials": trials,
        "score_version_new": int(TRY_GRASP_VERSION),
        "stored_mean": round(float(stored.mean()), 4),
        "fresh_mean": round(float(fresh.mean()), 4),
        "spearman": round(spearman_np(stored, fresh), 4),
        "pearson": round(float(np.corrcoef(stored, fresh)[0, 1]), 4),
        "mean_abs_diff": round(float(np.abs(stored - fresh).mean()), 4),
        "top_quartile_overlap": round(float(np.isin(
            np.argsort(fresh)[-len(fresh) // 4:],
            np.argsort(stored)[-len(stored) // 4:]).mean()), 4),
        "wall_s": round(wall_s, 1),
    }


def _save_npz(path: str, arrays: dict) -> None:
    tmp = path[:-len(".npz")] + ".tmp.npz"  # np.savez appends .npz
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def output_path(db_path: str, out_dir: str, rebalance: bool) -> str:
    """Where ``--write`` puts a re-scored DB: ``out_dir`` by the input's
    name, never the input itself nor a tracked directory."""
    name = os.path.basename(db_path)
    out_path = os.path.join(out_dir, name)
    refuse_tracked(out_path)
    if os.path.exists(out_path) and os.path.samefile(out_path, db_path):
        raise ValueError(f"{out_path} is the input DB; re-scored DBs never replace their input")
    if rebalance and "_complete_grasp" not in name:
        raise ValueError(f"--rebalance needs a *_complete_grasp.npz DB, got {name}")
    return out_path


def write_rescored(d: dict, fresh: np.ndarray, db_path: str, out_dir: str,
                   rebalance: bool) -> dict:
    """Write the DB ``d`` with the fresh scores and ``score_version`` under
    ``out_dir`` by the input's name and, with ``rebalance``, its
    ``*_balanced_grasp.npz`` (``balance_score_bins`` with
    ``config_grasp.yml``'s bins).  Returns the row's keys of what was
    written."""
    name = os.path.basename(db_path)
    out_path = output_path(db_path, out_dir, rebalance)
    os.makedirs(out_dir, exist_ok=True)
    d = dict(d, scores=fresh.astype(np.float32), score_version=np.int32(TRY_GRASP_VERSION))
    _save_npz(out_path, d)
    row = {"written": True}
    if rebalance:
        cfg = load_config("config_grasp.yml")
        bal = balance_score_bins(d, np.array(cfg["classes"]),
                                 int(cfg.get("max_per_score_bin", 1000)))
        bal_path = os.path.join(out_dir, name.replace("_complete_grasp", "_balanced_grasp"))
        _save_npz(bal_path, bal)
        row["rebalanced"] = os.path.basename(bal_path)
        row["n_balanced"] = int(len(bal["grasp_poses"]))
    return row


def run_one(args, db_path: str) -> dict:
    """One DB's row: the probe (or, with ``--write``, every pose re-scored
    and written), with ``--noise_floor`` a second seed's agreement."""
    n = None if args.write else args.n
    d, _, stored, fresh, wall = rescore(db_path, n, args.trials, args.seed, device=args.device)
    row = drift_row(db_path, stored, fresh, args.trials, wall)
    if args.noise_floor:
        fresh2 = rescore(db_path, n, args.trials, args.seed + 777, device=args.device)[3]
        row["noise_floor_spearman"] = round(spearman_np(fresh, fresh2), 4)
        row["noise_floor_mean_abs_diff"] = round(float(np.abs(fresh - fresh2).mean()), 4)
    if args.write:
        row.update(write_rescored(d, fresh, db_path, args.out_dir, args.rebalance))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", required=True, nargs="+")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=None, help="append each row to this JSONL file")
    ap.add_argument("--write", action="store_true",
                    help="re-score every pose and write the DB with the fresh scores and "
                         "score_version under --out_dir")
    ap.add_argument("--rebalance", action="store_true",
                    help="with --write: also write the DB's *_balanced_grasp.npz")
    ap.add_argument("--noise_floor", action="store_true",
                    help="re-score a second time with seed + 777: the same physics' agreement")
    ap.add_argument("--out_dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.out:
        refuse_tracked(args.out)
    for db_path in args.db if args.write else ():
        output_path(db_path, args.out_dir, args.rebalance)
    for db_path in args.db:
        run_one(args, db_path)


if __name__ == "__main__":
    main()
