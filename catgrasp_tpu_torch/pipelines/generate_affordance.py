"""Self-supervised task-affordance labels
(``catgrasp_tpu/pipelines/generate_affordance.py`` in PyTorch).

Per training object: load its grasp DB, roll every grasp through
``try_grasp`` (stability, insertion, drop, placement check) and accumulate
the per-surface-point P(task | stable grasp).  A chunk of grasps is one
scene batch on the device; chunks are padded to ``chunk`` grasps with
identity poses, so every dispatch has one shape.

    python -m catgrasp_tpu_torch.pipelines.generate_affordance --class_name nut \\
        --index 0 --grasp_db dataset/grasps/nut_train_0_complete_grasp.npz

The labels go to ``dataset/affordance_torch/`` by default, never over the
JAX package's ``dataset/affordance``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..geom import csg as csglib
from ..geom import primitives as prim
from ..sim import env_semantic as es
from ..sim.env_grasp import GripperSpec
from ..sim.types import build_shape_lib
from ..utils.outputs import refuse_tracked

DEFAULT_OUT_DIR = "dataset/affordance_torch"


def affordance_setup(class_name: str, split: str, index: int, n_aff_pts: int = 1024,
                     seed: int = 0, device=None):
    """The object and its instance-matched place fixture as a shape library
    (object 0, fixture 1), the affordance points drawn from
    ``default_rng(seed)`` and that generator, draw for draw as JAX."""
    mesh = prim.make_instance(class_name, split, index)
    ip = prim.instance_params(class_name, split, index)
    lib = build_shape_lib(
        [mesh, prim.place_fixture(class_name, ip)],
        [csglib.make_csg_instance(class_name, split, index),
         csglib.csg_place_fixture(class_name, ip)],
        n_surf=64, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    aff_pts = mesh.sample_surface(n_aff_pts, rng)
    return lib, aff_pts, rng


def try_grasp_chunks(lib, class_name: str, aff_pts: torch.Tensor, poses: np.ndarray,
                     chunk: int, spec: GripperSpec = GripperSpec(), verbose: bool = True,
                     label: str = ""):
    """``try_grasp`` over ``poses`` (G, 4, 4) in dispatches of ``chunk``
    grasps, the last padded with identity poses: (rets (G,) int, contact
    masks (G, P) bool) on the host."""
    dev = lib.device
    rets, masks = [], []
    n = len(poses)
    for i in range(0, n, chunk):
        block = poses[i:i + chunk]
        keep = len(block)
        if keep < chunk:
            block = np.concatenate([block, np.tile(np.eye(4, dtype=np.float32),
                                                   (chunk - keep, 1, 1))])
        r, m = es.try_grasp(lib, 0, 1, 1.0, torch.as_tensor(block, device=dev), class_name,
                            aff_pts, spec)
        rets.append(r[:keep].cpu().numpy())
        masks.append(m[:keep].cpu().numpy())
        if verbose:
            print(f"affordance {label}: {min(i + chunk, n)}/{n} grasps")
    return np.concatenate(rets), np.concatenate(masks)


def generate_affordance(class_name: str, split: str, index: int, grasp_db: dict,
                        n_aff_pts: int = 1024, chunk: int = 256, max_grasps: int = 100_000,
                        min_trials: int = 10, spec: GripperSpec = GripperSpec(),
                        seed: int = 0, device=None, verbose: bool = True) -> dict:
    """Returns dict(points, affordance, n_stable, rets, class_name, split,
    index, try_grasp_version) on the host."""
    dev = resolve_device(device)
    lib, aff_pts, rng = affordance_setup(class_name, split, index, n_aff_pts, seed, dev)
    poses = grasp_db["grasp_poses"]
    if len(poses) > max_grasps:
        poses = poses[rng.choice(len(poses), max_grasps, replace=False)]
    rets, masks = try_grasp_chunks(lib, class_name,
                                   torch.as_tensor(aff_pts, dtype=torch.float32, device=dev),
                                   np.asarray(poses, np.float32), chunk, spec, verbose,
                                   f"{class_name}/{index}")
    aff, n_stable = es.accumulate_affordance(rets, masks, min_trials=min_trials)
    return {
        "points": aff_pts.astype(np.float32),
        "affordance": aff,
        "n_stable": n_stable.astype(np.int32),
        "rets": rets.astype(np.int8),
        "class_name": class_name, "split": split, "index": index,
        # provenance: which try_grasp semantics produced these labels
        "try_grasp_version": np.int32(es.TRY_GRASP_VERSION),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--split", default="train")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--grasp_db", required=True)
    ap.add_argument("--out_dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--max_grasps", type=int, default=100_000)
    ap.add_argument("--min_trials", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=256,
                    help="grasps per device dispatch (one scene batch)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    refuse_tracked(args.out_dir)

    db = dict(np.load(args.grasp_db))
    out = generate_affordance(args.class_name, args.split, args.index, db,
                              max_grasps=args.max_grasps, min_trials=args.min_trials,
                              chunk=args.chunk, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    path = f"{args.out_dir}/{args.class_name}_{args.split}_{args.index}_affordance.npz"
    np.savez_compressed(path, **out)
    r = out["rets"]
    print(f"saved {path}: grasp-fail {np.mean(r == 0):.2f} stable {np.mean(r == 1):.2f} "
          f"task-success {np.mean(r == 2):.2f}")
    return path


if __name__ == "__main__":
    main()
