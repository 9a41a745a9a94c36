"""Offline grasp-database generation (``catgrasp_tpu/pipelines/generate_grasp.py``
in PyTorch).

Per object instance:
  1. sample surface points on the mesh (numpy's rng, draw for draw as JAX),
  2. cone-sample + augment grasp candidates and filter them against the
     object's own cloud only (no IK or camera gates: the complete grasp
     space; the closing volume meets a background of one point at
     infinity), the collision gate being kernel K1,
  3. physics-score every surviving candidate: the perturbation-robustness
     score, ``score_chunk`` grasps x ``trials`` rollouts a scene batch,
  4. balance into score bins, at most ``max_per_score_bin`` each,
  5. save ``.npz`` DBs (complete and balanced).

The sampler's and the scorer's draws come from one ``torch.Generator`` on
the device seeded with ``seed``; JAX's come from ``jax.random``, so the
candidates differ from the JAX DB's for the same seed.

    python -m catgrasp_tpu_torch.pipelines.generate_grasp --class_name nut
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config.loader import load_config
from ..device import resolve_device
from ..geom import csg as csglib
from ..geom import primitives as prim
from ..geom.mesh import TriMesh
from ..grasp.filter import compact_valid
from ..grasp.gripper import Gripper
from ..grasp.sampler import PointConeGraspSampler
from ..sim import env_grasp as eg
from ..sim.types import build_shape_lib
from ..utils.outputs import refuse_tracked

# the port's DBs go here, never over the JAX package's dataset/grasps
DEFAULT_OUT_DIR = "dataset/grasps_torch"


def generate_complete_grasps(class_name: str, split: str, index: int, gripper: Gripper,
                             cfg: dict, seed: int = 0, max_candidates: int = 4096,
                             score_chunk: int = 256, trials: int | None = None,
                             obj_path: str | None = None, device=None,
                             info: dict | None = None) -> dict:
    """Candidates and their perturbation scores for one object: a dict of
    ``grasp_poses`` (K, 4, 4), ``scores`` (K,), ``class_name``, ``split``,
    ``index``, on the host.

    ``obj_path``: an external watertight .obj, scored through its baked SDF
    grid (``narrowphase="grid"``) instead of the procedural CSG tree.
    ``info``, when given, receives the filter's counters (``stats``) and the
    synchronised wall times of sampling + filter and of scoring."""
    dev = resolve_device(device)
    if obj_path:
        mesh, csg, narrowphase = TriMesh.load_obj(obj_path), None, "grid"
    else:
        mesh = prim.make_instance(class_name, split, index)
        csg = csglib.make_csg_instance(class_name, split, index)
        narrowphase = "csg"
    rng = np.random.default_rng(seed)
    n_pts = int(cfg.get("n_surface_points_db", 200))
    points, normals = mesh.sample_surface(n_pts, rng, return_normals=True)
    gen = torch.Generator(device=dev).manual_seed(seed)

    t0 = time.perf_counter()
    sampler = PointConeGraspSampler(
        gripper,
        max_num_samples=int(cfg.get("max_num_surface_points", 100)),
        n_sphere_dir=int(cfg.get("n_sphere_dir", 10)),
        approach_step=float(cfg.get("approach_step", 0.006)),
    )
    # complete space: no camera or IK gates; the closing volume meets a
    # background of one point at infinity
    far = np.full((1, 3), 999.0, np.float32)
    poses, valid, stats = sampler.sample_grasps(
        torch.from_numpy(points).to(dev), torch.from_numpy(normals).to(dev),
        background_cloud=far, background_mask=np.ones(1, bool), generator=gen,
        filter_ik=False, filter_approach=False)
    poses = compact_valid(poses, valid)
    if len(poses) > max_candidates:
        poses = poses[rng.choice(len(poses), max_candidates, replace=False)]
    stats = {k: int(v) for k, v in stats.items()}
    t1 = time.perf_counter()
    print(f"{class_name}/{split}/{index}: {len(poses)} collision-free candidates "
          f"(stats={stats})", flush=True)

    # --- physics scoring, chunked over grasps ------------------------------
    lib = build_shape_lib([mesh], [csg] if csg is not None else None, n_surf=64, seed=seed,
                          bake_grids=narrowphase == "grid", device=dev)
    trials = trials if trials is not None else int(cfg.get("perturbation_trials", 50))
    poses_dev = torch.from_numpy(poses).to(dev)
    scores = [eg.perturbation_scores(gen, lib, 0, 1.0, poses_dev[i:i + score_chunk],
                                     trials=trials, spec=gripper.spec, narrowphase=narrowphase)
              for i in range(0, len(poses), score_chunk)]
    scores = torch.cat(scores).cpu().numpy() if scores else np.zeros(0, np.float32)
    if info is not None:
        info.update(stats=stats, sample_filter_s=t1 - t0, scoring_s=time.perf_counter() - t1)
    return {
        "grasp_poses": poses.astype(np.float32),
        "scores": scores.astype(np.float32),
        "class_name": class_name,
        "split": split,
        "index": index,
    }


def balance_score_bins(db: dict, bins: np.ndarray, max_per_bin: int = 1000,
                       seed: int = 0) -> dict:
    """At most ``max_per_bin`` grasps per score bin."""
    rng = np.random.default_rng(seed)
    which = np.digitize(db["scores"], bins) - 1
    keep = []
    for b in range(len(bins) - 1):
        ids = np.where(which == b)[0]
        if len(ids) > max_per_bin:
            ids = rng.choice(ids, max_per_bin, replace=False)
        keep.append(ids)
    keep = np.concatenate(keep) if keep else np.zeros(0, int)
    out = dict(db)
    out["grasp_poses"] = db["grasp_poses"][keep]
    out["scores"] = db["scores"][keep]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--split", default="train")
    ap.add_argument("--index", type=int, default=-1, help="-1 = all instances")
    ap.add_argument("--out_dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--obj", default=None,
                    help="external watertight .obj instead of a procedural instance (scored "
                         "through the grid-SDF narrowphase)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    refuse_tracked(args.out_dir)

    cfg = load_config("config_grasp.yml")
    gripper = Gripper.default()
    os.makedirs(args.out_dir, exist_ok=True)
    if args.obj:
        indices = [max(args.index, 0)]
    else:
        indices = (range(prim.num_instances(args.class_name, args.split))
                   if args.index < 0 else [args.index])
    bins = np.array(cfg["classes"])
    for i in indices:
        t0 = time.perf_counter()
        db = generate_complete_grasps(args.class_name, args.split, i, gripper, cfg,
                                      trials=args.trials, obj_path=args.obj, device=args.device)
        if args.obj:
            stem = os.path.splitext(os.path.basename(args.obj))[0]
            path = f"{args.out_dir}/{stem}_complete_grasp.npz"
        else:
            path = f"{args.out_dir}/{args.class_name}_{args.split}_{i}_complete_grasp.npz"
        np.savez_compressed(path, **db)
        bal = balance_score_bins(db, bins, int(cfg.get("max_per_score_bin", 1000)))
        np.savez_compressed(path.replace("_complete_", "_balanced_"), **bal)
        hist = np.histogram(db["scores"], bins)[0].tolist()
        print(f"saved {path}: {len(db['scores'])} grasps, "
              f"score mean {db['scores'].mean() if len(db['scores']) else 0:.3f}, "
              f"bins {hist}, balanced {len(bal['scores'])}, "
              f"wall_s={time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
