"""How far affordance labels agree across platforms for the same code.

Runs JAX's ``try_grasp`` on the host CPU over the first ``--n`` grasps of
one instance's stored grasp DB, and compares the outcomes with the stored
affordance labels, which were made by the same code on another platform:
the per-grasp agreement of ``ret`` and the outcome shares.  This is the
floor that another implementation's per-grasp agreement is judged by (the
close, the shake and the drop are chaotic).  With ``--port 1`` the PyTorch
port's ``try_grasp`` runs on the same grasps on the CPU too, and is
compared with both.

    JAX_PLATFORMS=cpu python scripts/affordance_floor.py --class_name nut --n 256 --port 1

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def shares(r: np.ndarray) -> list:
    return [float(np.mean(r == k)) for k in (0, 1, 2)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from catgrasp_tpu.geom import csg as csglib
    from catgrasp_tpu.geom import primitives as prim
    from catgrasp_tpu.sim import env_semantic as es
    from catgrasp_tpu.sim.env_grasp import GripperSpec
    from catgrasp_tpu.sim.types import build_shape_lib

    cls, idx = args.class_name, args.index
    db = np.load(f"dataset/grasps/{cls}_train_{idx}_complete_grasp.npz")
    stored = np.load(f"dataset/affordance/{cls}_train_{idx}_affordance.npz")
    poses = db["grasp_poses"][:args.n]
    mesh = prim.make_instance(cls, "train", idx)
    ip = prim.instance_params(cls, "train", idx)
    lib = build_shape_lib([mesh, prim.place_fixture(cls, ip)],
                          [csglib.make_csg_instance(cls, "train", idx),
                           csglib.csg_place_fixture(cls, ip)], n_surf=64, seed=0)
    aff = mesh.sample_surface(1024, np.random.default_rng(0))
    fn = jax.jit(jax.vmap(lambda G: es.try_grasp(lib, jnp.int32(0), jnp.int32(1),
                                                 jnp.float32(1.0), G, cls, jnp.asarray(aff),
                                                 GripperSpec())))
    t0 = time.perf_counter()
    jax_rets = np.concatenate([np.asarray(fn(jnp.asarray(poses[i:i + args.chunk]))[0])
                               for i in range(0, len(poses), args.chunk)])
    out = {"class_name": cls, "index": idx, "n": len(poses),
           "jax_cpu_s": round(time.perf_counter() - t0, 2),
           "stored_shares": shares(stored["rets"][:len(poses)]),
           "jax_cpu_shares": shares(jax_rets),
           "jax_cpu_vs_stored_agree": float(np.mean(jax_rets == stored["rets"][:len(poses)]))}
    if args.port:
        import torch

        from catgrasp_tpu_torch.pipelines import generate_affordance as ga
        from catgrasp_tpu_torch.sim import env_semantic as tes
        plib, paff, _ = ga.affordance_setup(cls, "train", idx, device="cpu")
        t0 = time.perf_counter()
        port_rets = np.concatenate([
            tes.try_grasp(plib, 0, 1, 1.0, torch.as_tensor(poses[i:i + args.chunk]), cls,
                          torch.as_tensor(paff))[0].numpy()
            for i in range(0, len(poses), args.chunk)])
        out.update(port_cpu_s=round(time.perf_counter() - t0, 2),
                   port_cpu_shares=shares(port_rets),
                   port_cpu_vs_stored_agree=float(np.mean(port_rets
                                                          == stored["rets"][:len(poses)])),
                   port_cpu_vs_jax_cpu_agree=float(np.mean(port_rets == jax_rets)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
