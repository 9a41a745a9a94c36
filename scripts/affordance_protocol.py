"""The affordance protocol: the port's labels and canonicals beside the
tracked JAX ones.

For every training instance of nut, screw and hnm: the port's
``generate_affordance`` over its tracked grasp DB (``dataset/grasps``), the
labels written under ``--out_dir`` and compared with the tracked JAX labels
(``dataset/affordance``): the outcome counts, the per-grasp agreement of
``ret``, the Pearson correlation of the point affordance.  Per class,
pooled: the outcome shares against JAX's with 2 binomial SD, the agreement,
the median per-instance correlation.  Then ``compute_canonical`` per class
from the port's labels on the device, its medoid and codebook against the
same call on the CPU (which ``tests/test_torch_canonical.py`` holds equal
to JAX's), and its canonical affordance against the tracked
``dataset/<class>_canonical.npz``.

    python scripts/affordance_protocol.py --chunk 4096 --out affordance_protocol.jsonl

Prints (and appends to ``--out``) one JSON line an instance and one a
class.  ``compare_labels`` and ``compare_canonical`` are the comparisons
``chip_smoke.py``'s affordance phase makes too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

CLASSES = ("nut", "screw", "hnm")


def pearson(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def compare_outcomes(rets: np.ndarray, ref_rets: np.ndarray) -> dict:
    """The outcome counts (fail / stable / task) beside the reference's,
    with 2 binomial SD of the reference's shares at this count, and the
    per-grasp agreement."""
    n = len(rets)
    counts, ref = np.bincount(rets, minlength=3), np.bincount(ref_rets, minlength=3)
    p = ref / n
    two_sd = 2 * np.sqrt(n * p * (1 - p))
    return {"grasps": n, "outcomes": counts.tolist(), "jax_outcomes": ref.tolist(),
            "two_sd_counts": two_sd.tolist(),
            "within_two_sd": bool(np.all(np.abs(counts - ref) <= two_sd)),
            "ret_agree": float(np.mean(rets == ref_rets))}


def compare_labels(out: dict, ref: dict) -> dict:
    """One instance's labels (``generate_affordance``'s keys) against the
    reference's: ``compare_outcomes`` and the point affordance."""
    return dict(compare_outcomes(out["rets"], ref["rets"]),
                affordance_pearson=pearson(out["affordance"], ref["affordance"]),
                affordance_mean_abs_diff=float(np.abs(out["affordance"]
                                                      - ref["affordance"]).mean()),
                points_equal_jax=bool(np.array_equal(out["points"], ref["points"])))


def compare_canonical(canon: dict, cpu: dict, tracked: dict) -> dict:
    """A canonical made on the device against the same call on the CPU
    (each field equal; the affordance codebook's largest |diff|) and
    against the tracked file (the medoid, the affordance correlation)."""
    keys = ("medoid_index", "canonical_grasps", "canonical_grasp_scores",
            "canonical_affordance")
    return {"medoid": int(canon["medoid_index"]),
            "medoid_tracked": int(tracked["medoid_index"]),
            "n_codebook": len(canon["canonical_grasps"]),
            "equal_cpu": {k: bool(np.array_equal(canon[k], cpu[k])) for k in keys},
            "affordance_max_abs_diff_cpu": float(np.abs(
                canon["canonical_affordance"] - cpu["canonical_affordance"]).max()),
            "canonical_affordance_pearson": pearson(canon["canonical_affordance"],
                                                    tracked["canonical_affordance"]),
            "canonical_affordance_mean_abs_diff": float(np.abs(
                canon["canonical_affordance"] - tracked["canonical_affordance"]).mean())}


def run_class(cls: str, chunk: int, out_dir: str, dev, emit) -> dict:
    """Every training instance of ``cls`` and its canonical; returns the
    class's pooled row."""
    from catgrasp_tpu_torch.device import sync
    from catgrasp_tpu_torch.geom import primitives as prim
    from catgrasp_tpu_torch.pipelines import generate_affordance as ga
    from catgrasp_tpu_torch.pipelines import make_canonical as mc

    rows, walls, labels, refs = [], [], [], []
    for i in range(prim.num_instances(cls, "train")):
        db = dict(np.load(f"dataset/grasps/{cls}_train_{i}_complete_grasp.npz"))
        ref = np.load(f"dataset/affordance/{cls}_train_{i}_affordance.npz")
        sync(dev)
        t0 = time.perf_counter()
        out = ga.generate_affordance(cls, "train", i, db, chunk=chunk, device=dev,
                                     verbose=False)
        sync(dev)
        walls.append(time.perf_counter() - t0)
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(f"{out_dir}/{cls}_train_{i}_affordance.npz", **out)
        labels.append(out)
        refs.append(ref["rets"])
        rows.append(compare_labels(out, ref))
        emit(dict({"class": cls, "index": i, "wall_s": walls[-1]}, **rows[-1]))

    dbs, _ = mc.load_inputs(cls, "dataset/grasps", "dataset/affordance")
    sync(dev)
    t0 = time.perf_counter()
    canon = mc.compute_canonical(cls, dbs, labels, device=dev)
    sync(dev)
    canon_s = time.perf_counter() - t0
    cpu = mc.compute_canonical(cls, dbs, labels, device="cpu")
    row = dict({"class": cls, "instances": len(rows),
                "wall_s_per_instance": float(np.mean(walls)),
                "wall_s_total": float(np.sum(walls))},
               **compare_outcomes(np.concatenate([lb["rets"] for lb in labels]),
                                  np.concatenate(refs)),
               affordance_pearson_median=float(np.median([r["affordance_pearson"]
                                                          for r in rows])),
               canonical_s=canon_s,
               **compare_canonical(canon, cpu, np.load(f"dataset/{cls}_canonical.npz")))
    emit(row)
    return row


def main(argv=None):
    from catgrasp_tpu_torch.device import resolve_device
    from catgrasp_tpu_torch.pipelines import generate_affordance as ga

    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", default=",".join(CLASSES))
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--out_dir", default=ga.DEFAULT_OUT_DIR)
    ap.add_argument("--out", default=None, help="JSONL file the rows are appended to")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    return [run_class(c, args.chunk, args.out_dir, dev, emit) for c in args.classes.split(",")]


if __name__ == "__main__":
    main()
