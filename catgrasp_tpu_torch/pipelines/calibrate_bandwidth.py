"""Calibrate the seg predicter's MeanShift bandwidth from its net's offset
noise (``scripts/calibrate_bandwidth.py`` in PyTorch).

The clustering bandwidth must track the seg net's offset residual: the
spread of the shifted points (xyz + predicted offset) around their
ground-truth instance's mean, on val scenes.  This writes
``<artifacts>/seg/calib.json``, which ``predict.artifacts`` reads:

    bandwidth = clip(0.9 x p50(residual), 0.006, 0.02)

    python -m catgrasp_tpu_torch.pipelines.calibrate_bandwidth --class_name nut \\
        --artifacts artifacts_torch/nut --val_dir dataset/torch/nut/val

The seg net runs on the GPU unless ``--device cpu``.  The tracked
``artifacts_tracked/`` is never written.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from ..data.labels import load_scene
from ..device import resolve_device
from ..predict.artifacts import load_predicters
from ..utils.outputs import refuse_tracked

FORMULA = "clip(0.9*p50, 0.006, 0.02)"


def shifted_residuals(files: list, n_pts: int, forward, device) -> list:
    """Each instance's residuals (distances of its shifted points to their
    mean), scene by scene: up to ``n_pts`` visible points a scene drawn by
    ``default_rng(0)`` as the JAX script draws them, offsets from
    ``forward(xyz, normals, origin)``; scenes with < 500 visible points and
    instances with < 30 sampled points are skipped."""
    rng = np.random.default_rng(0)
    residuals = []
    for f in files:
        d = load_scene(f)
        seg = d["seg"].reshape(-1)
        xyz = d["xyz"].reshape(-1, 3)
        nrm = d["normal"].reshape(-1, 3)
        vm = seg >= 0
        if vm.sum() < 500:
            continue
        ids = np.where(vm)[0]
        ids = rng.choice(ids, min(len(ids), n_pts), replace=False)
        x = torch.as_tensor(xyz[ids], dtype=torch.float32, device=device)
        n = torch.as_tensor(nrm[ids], dtype=torch.float32, device=device)
        origin = x.amin(dim=0) - 0.01
        shifted = (x + forward(x, n, origin)).cpu().numpy()
        inst = seg[ids]
        for i in np.unique(inst):
            m = inst == i
            if m.sum() < 30:
                continue
            c = shifted[m].mean(0)
            residuals.append(np.linalg.norm(shifted[m] - c, axis=1))
    return residuals


def calibration(residuals: list) -> tuple[dict, float]:
    """(the residuals' p50, p75 and p90, the bandwidth)."""
    r = np.concatenate(residuals)
    stats = {f"p{p}": float(np.percentile(r, p)) for p in (50, 75, 90)}
    return stats, float(np.clip(0.9 * stats["p50"], 0.006, 0.02))


def main(argv=None) -> dict | None:
    """Calibrate and write ``calib.json``; returns what it wrote (or, with
    ``--dry``, would write), None when there is nothing to calibrate."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--artifacts", default=None,
                    help="the directory holding seg/ (default artifacts_torch/<class>)")
    ap.add_argument("--val_dir", default=None,
                    help="scene records (default dataset/torch/<class>/val)")
    ap.add_argument("--n_scenes", type=int, default=6)
    ap.add_argument("--dry", action="store_true", help="print stats, don't write")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    art = args.artifacts or f"artifacts_torch/{args.class_name}"
    val_dir = args.val_dir or f"dataset/torch/{args.class_name}/val"
    out_path = os.path.join(art, "seg", "calib.json")
    if not args.dry:
        refuse_tracked(out_path)
    dev = resolve_device(args.device)
    pred = load_predicters(art, args.class_name, device=dev, roles=("seg",)).get("seg")
    if pred is None:
        print(f"no seg checkpoint under {art}; nothing to calibrate")
        return None
    files = sorted(glob.glob(f"{val_dir}/*.npz"))[: args.n_scenes]
    if not files:
        print(f"no val scenes under {val_dir}")
        return None

    def forward(x, n, origin):
        with torch.inference_mode():
            return pred.model(x, n, origin)[0]

    residuals = shifted_residuals(files, pred.n_pts, forward, dev)
    if not residuals:
        print("no instances found; aborting")
        return None
    stats, bandwidth = calibration(residuals)
    print(f"{args.class_name}: residual stats {stats} -> bandwidth {bandwidth:.4f}")
    out = {"bandwidth": round(bandwidth, 4), "stats": stats, "n_scenes": len(files),
           "formula": FORMULA}
    if not args.dry:
        with open(out_path, "w") as fo:
            json.dump(out, fo, indent=1)
        print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    main()
