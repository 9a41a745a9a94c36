"""Per-object SDF grid generation (``catgrasp_tpu/pipelines/make_sdf.py`` in
PyTorch).

The reference shells out to ``SDFGen`` per mesh (dim = ceil(maxdim / 0.001)
+ 2 * 5 voxels) and stores ``.sdf`` text files next to the models.  Here the
bake is ``geom.sdf.bake_sdf`` on the device, and the output is an ``.npz``
grid and, with ``--write_sdf 1``, an SDFGen-format ``.sdf`` file.

    python -m catgrasp_tpu_torch.pipelines.make_sdf --class_name nut
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..geom import primitives as prim
from ..geom import sdf as sdflib
from ..geom.sdf_io import write_sdf
from ..utils.outputs import refuse_tracked

# the port's grids go here, never over the JAX package's dataset/sdf
DEFAULT_OUT_DIR = "dataset/sdf_torch"


def make_sdf_one(vertices: np.ndarray, faces: np.ndarray, resolution: float = 0.001,
                 padding: int = 5, max_dims: int = 128, device=None):
    """Bake one mesh at the reference's settings: a cell of about
    ``resolution``, ``padding`` empty voxels on each side, at most
    ``max_dims`` a side.  Returns (values (D, D, D), lower (3,), spacing)
    on the host."""
    extent = float((vertices.max(0) - vertices.min(0)).max())
    dims = int(np.ceil(extent / resolution)) + 2 * padding
    dims = min(max(dims, 8), max_dims)
    grid = sdflib.bake_sdf(vertices, faces, dims=dims, padding=padding * resolution,
                           device=device)
    return grid.values.cpu().numpy(), grid.lower.cpu().numpy(), float(grid.spacing)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--splits", default="train,test")
    ap.add_argument("--resolution", type=float, default=0.001)
    ap.add_argument("--padding", type=int, default=5)
    ap.add_argument("--max_dims", type=int, default=128)
    ap.add_argument("--out_dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--write_sdf", type=int, default=0,
                    help="also write reference-format .sdf text files")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    refuse_tracked(args.out_dir)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for split in args.splits.split(","):
        for i in range(prim.num_instances(args.class_name, split)):
            mesh = prim.make_instance(args.class_name, split, i)
            values, lower, spacing = make_sdf_one(
                np.asarray(mesh.vertices), np.asarray(mesh.faces), args.resolution,
                args.padding, args.max_dims, device=args.device)
            stem = f"{args.out_dir}/{args.class_name}_{split}_{i}"
            np.savez_compressed(f"{stem}.npz", values=values, lower=lower, spacing=spacing)
            if args.write_sdf:
                write_sdf(f"{stem}.sdf", values, lower, spacing)
            print(f"{stem}: dims={values.shape} spacing={spacing*1e3:.2f}mm "
                  f"inside_frac={(values < 0).mean():.3f}", flush=True)
    print(f"wall_s={time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
