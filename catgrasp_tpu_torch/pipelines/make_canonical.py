"""Category-level NUNOCS canonical model
(``catgrasp_tpu/pipelines/make_canonical.py`` in PyTorch).

``compute_canonical``:
  1. per training instance: a surface cloud in NUNOCS (per-axis bounding-box
     normalisation to the centred unit cube),
  2. the medoid instance by mutual chamfer distance,
  3. the grasp codebook: every DB grasp with perturbation score >= the
     threshold, mapped into the NUNOCS frame (anisotropic similarity),
  4. the affordance codebook: each canonical point's affordance averaged
     over the labelled instances through its nearest neighbour in NUNOCS.

The draws and the NUNOCS maps are host numpy, draw for draw and operation
for operation as JAX; the chamfer distances' nearest-neighbour minima and
the affordance nearest neighbours run in torch on the device, the squared
distances summed in numpy's order, so both packages pick the same medoid
and the same neighbours.

    python -m catgrasp_tpu_torch.pipelines.make_canonical --class_name nut

writes ``dataset/canonical_torch/<class>_canonical.npz`` by default, never
over the JAX package's ``dataset/<class>_canonical.npz``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..geom import primitives as prim
from ..utils.outputs import refuse_tracked

DEFAULT_OUT_DIR = "dataset/canonical_torch"
AFFORDANCE_RADIUS = 0.05  # NUNOCS units: a canonical point farther from every label gets none


def to_nunocs_transform(points: np.ndarray) -> np.ndarray:
    """4x4 anisotropic similarity mapping object coords -> CENTERED NUNOCS
    [-0.5, 0.5]^3.  The canonical frame is centered so category symmetry
    transforms apply about the origin."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    ext = np.maximum(hi - lo, 1e-9)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.diag(1.0 / ext)
    T[:3, 3] = -lo / ext - 0.5
    return T


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., Na, Nb) between point sets (..., Na, 3) and
    (..., Nb, 3), the three squares summed in numpy's order."""
    d = a[..., :, None, :] - b[..., None, :, :]
    d = d * d
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def mutual_chamfer(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Mean nearest-neighbour distance from a (..., Na, 3) to b (..., Nb, 3)
    plus the same from b to a, over leading axes: (...) float64.  The minima
    are taken on ``a``'s device, the means on the host as numpy takes them."""
    d2 = _sq_dists(a, b)
    m_ab = torch.amin(d2, dim=-1).cpu().numpy()
    m_ba = torch.amin(d2, dim=-2).cpu().numpy()
    out = [np.sqrt(x).mean() + np.sqrt(y).mean() for x, y in
           zip(m_ab.reshape(-1, m_ab.shape[-1]), m_ba.reshape(-1, m_ba.shape[-1]))]
    return np.asarray(out, np.float64).reshape(m_ab.shape[:-1])


def compute_canonical(class_name: str, grasp_dbs: list[dict],
                      affordances: list[dict] | None = None,
                      n_pts: int = 1024, score_thresh: float = 0.8,
                      seed: int = 0, device=None) -> dict:
    """The category's canonical model from its training instances' grasp
    DBs and (optionally) affordance labels, ``None`` for a missing one."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_inst = prim.num_instances(class_name, "train")
    clouds, tfs = [], []
    for i in range(n_inst):
        mesh = prim.make_instance(class_name, "train", i)
        pts = mesh.sample_surface(n_pts, rng)
        T = to_nunocs_transform(mesh.vertices)
        nocs = pts @ T[:3, :3].T + T[:3, 3]
        clouds.append(nocs.astype(np.float32))
        tfs.append(T)

    # the medoid by mutual chamfer over 256-point subsamples
    sub = [c[rng.choice(len(c), min(256, len(c)), replace=False)] for c in clouds]
    sub = torch.as_tensor(np.stack(sub), device=dev)
    ii, jj = np.triu_indices(n_inst, 1)
    D = np.zeros((n_inst, n_inst))
    D[ii, jj] = D[jj, ii] = mutual_chamfer(sub[torch.as_tensor(ii, device=dev)],
                                           sub[torch.as_tensor(jj, device=dev)])
    medoid = int(D.sum(1).argmin())

    # the grasp codebook
    canon_grasps, canon_scores = [], []
    for i, db in enumerate(grasp_dbs):
        if db is None:
            continue
        keep = db["scores"] >= score_thresh
        g = db["grasp_poses"][keep].copy()
        T = tfs[int(db.get("index", i))]
        g = np.einsum("ij,njk->nik", T, g)
        canon_grasps.append(g)
        canon_scores.append(db["scores"][keep])
    canon_grasps = (np.concatenate(canon_grasps) if canon_grasps
                    else np.zeros((0, 4, 4), np.float32))
    canon_scores = (np.concatenate(canon_scores) if canon_scores
                    else np.zeros((0,), np.float32))

    # the affordance codebook: each canonical point takes its nearest
    # labelled point of every instance within the radius; sums in float64
    canon_cloud = clouds[medoid]
    canon_aff = np.zeros(len(canon_cloud), np.float32)
    if affordances:
        cloud_d = torch.as_tensor(canon_cloud, device=dev)
        acc = torch.zeros(len(canon_cloud), dtype=torch.float64, device=dev)
        cnt = torch.zeros(len(canon_cloud), dtype=torch.float64, device=dev)
        for a in affordances:
            if a is None:
                continue
            T = tfs[int(a.get("index", 0))]
            pts_nocs = a["points"] @ T[:3, :3].T + T[:3, 3]
            d2 = _sq_dists(cloud_d, torch.as_tensor(pts_nocs, device=dev))
            d_nn, nn = torch.min(d2, dim=1)
            ok = d_nn < AFFORDANCE_RADIUS ** 2
            aff = torch.as_tensor(a["affordance"], device=dev)[nn].to(torch.float64)
            acc = acc + torch.where(ok, aff, 0.0)
            cnt = cnt + ok.to(torch.float64)
        canon_aff = (acc / torch.clamp(cnt, min=1)).to(torch.float32).cpu().numpy()

    return {
        "canonical_cloud": canon_cloud,
        "canonical_affordance": canon_aff,
        "canonical_grasps": canon_grasps.astype(np.float32),
        "canonical_grasp_scores": canon_scores.astype(np.float32),
        "transforms_to_nocs": np.stack(tfs),
        "medoid_index": medoid,
        "class_name": class_name,
        # provenance: the oldest try_grasp semantics among the affordance
        # inputs (files without the stamp count as version 2)
        "affordance_version": np.int32(min(
            (int(a.get("try_grasp_version", 2)) for a in (affordances or [])
             if a is not None), default=0)),
    }


def load_inputs(class_name: str, grasp_dir: str, affordance_dir: str):
    """Each training instance's grasp DB and affordance labels, ``None``
    where the file is missing."""
    dbs, affs = [], []
    for i in range(prim.num_instances(class_name, "train")):
        p = f"{grasp_dir}/{class_name}_train_{i}_complete_grasp.npz"
        dbs.append(dict(np.load(p)) if os.path.exists(p) else None)
        p = f"{affordance_dir}/{class_name}_train_{i}_affordance.npz"
        affs.append(dict(np.load(p)) if os.path.exists(p) else None)
    return dbs, affs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--grasp_dir", default="dataset/grasps")
    ap.add_argument("--affordance_dir", default="dataset/affordance")
    ap.add_argument("--out", default=None,
                    help=f"output .npz (default {DEFAULT_OUT_DIR}/<class>_canonical.npz)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    path = args.out or f"{DEFAULT_OUT_DIR}/{args.class_name}_canonical.npz"
    refuse_tracked(path)

    dbs, affs = load_inputs(args.class_name, args.grasp_dir, args.affordance_dir)
    out = compute_canonical(args.class_name, dbs, affs, device=args.device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"saved {path}: {len(out['canonical_grasps'])} codebook grasps, "
          f"medoid instance {out['medoid_index']}")
    return path


if __name__ == "__main__":
    main()
