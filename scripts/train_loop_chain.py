"""The port's training loop on nut, end to end on one GPU: pile data, the
packer, the three trainers warm-started from the tracked nets, the seg
net's bandwidth calibration, the learned eval with the trained nets beside
the tracked ones, and both sets scored offline on the port's val split.

Stages (each a set of processes side by side; a stage's wall time, exit
codes and logs go to ``--out``):

1. ``generate_pile_data``: nut train scenes 0-1,023 (seed 0) in four
   ``--start`` shards of 256, which draw the scenes of one uninterrupted
   run, and 128 val scenes (seed 1);
2. ``pack_training_data`` on both splits against ``dataset/grasps``;
3. ``train_seg``, ``train_nunocs`` and ``train_grasp`` with
   ``--init_params artifacts_tracked/nut/<net>/best_val.ckpt``, the packed
   val split and ``--max_seconds``, into ``artifacts_torch/nut_warm/<net>``
   (``train_grasp`` writes ``prior.json``);
4. ``calibrate_bandwidth`` of the trained seg net on the val scenes, and
   ``--dry`` for the tracked one;
5. ``run_grasp_simulation --oracle 0`` at the eval-matrix settings (2
   rounds of 8 objects, seeds 0-2) with ``--artifacts
   artifacts_torch/nut_warm`` and with ``artifacts_tracked/nut``;
6. ``scripts/train_offline_score.py`` of both sets;
7. the verdict: each set's task successes over the seeds, against JAX's
   learned nut rate (37 of 45, ``logs/eval_matrix_r5.jsonl``) and the
   trained set against the tracked control's rate, each within 2 binomial
   SD on the port's object count; where the trained set falls outside,
   three more protocols, each with one trained net beside the two tracked
   ones (``swap``), name the net at fault.

    python scripts/train_loop_chain.py --out chiprun_out/train_loop
    # a stage again on what is there: --stages eval,offline,verdict
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
WARM, TRACKED = "artifacts_torch/nut_warm", "artifacts_tracked/nut"
SCENES, PACKED = "dataset/torch/nut/{}", "dataset/torch/nut/packed_{}"
N_TRAIN, N_VAL, SHARDS = 1024, 128, 4
SEEDS = (0, 1, 2)
NETS = ("seg", "nunocs", "grasp")


def module(name: str, *args) -> list:
    return [PY, "-m", f"catgrasp_tpu_torch.pipelines.{name}", *map(str, args)]


def evals(tag: str, artifacts: str, out: str) -> dict:
    """The learned protocol of one set of nets: a process a seed."""
    return {f"eval_{tag}_seed{s}": module(
        "run_grasp_simulation", "--class_name", "nut", "--n_rounds", 2, "--n_objects", 8,
        "--oracle", 0, "--seed", s, "--artifacts", artifacts,
        "--canonical", "dataset/nut_canonical.npz",
        "--metrics", os.path.join(out, f"events_{tag}_seed{s}.jsonl")) for s in SEEDS}


def swap_sets() -> dict:
    """Three sets of one trained net beside the two tracked ones
    (``artifacts_torch/nut_swap_<net>``), to name a net at fault."""
    sets = {}
    for net in NETS:
        d = f"artifacts_torch/nut_swap_{net}"
        shutil.rmtree(d, ignore_errors=True)
        for other in NETS:
            shutil.copytree(os.path.join(WARM if other == net else TRACKED, other),
                            os.path.join(d, other))
        sets[f"swap_{net}"] = d
    return sets


def stages(args) -> dict:
    out = args.out
    shard = N_TRAIN // SHARDS
    gen = {f"generate_train_{i}": module(
        "generate_pile_data", "--class_name", "nut", "--split", "train", "--n_scenes",
        (i + 1) * shard, "--start", i * shard, "--seed", 0) for i in range(SHARDS)}
    gen["generate_val"] = module("generate_pile_data", "--class_name", "nut", "--split", "val",
                                 "--n_scenes", N_VAL, "--seed", 1)
    train = {f"train_{net}": module(
        f"train_{net}", "--class_name", "nut", "--init_params",
        f"{TRACKED}/{net}/best_val.ckpt", "--val_root", PACKED.format("val"),
        "--max_seconds", args.max_seconds, "--ckpt_dir", f"{WARM}/{net}") for net in NETS}
    return {
        "generate": gen,
        "pack": {f"pack_{s}": module("pack_training_data", "--class_name", "nut", "--split", s)
                 for s in ("train", "val")},
        "train": train,
        "calibrate": {
            "calibrate_warm": module("calibrate_bandwidth", "--class_name", "nut", "--artifacts",
                                     WARM, "--val_dir", SCENES.format("val")),
            "calibrate_tracked": module("calibrate_bandwidth", "--class_name", "nut",
                                        "--artifacts", TRACKED, "--val_dir",
                                        SCENES.format("val"), "--dry")},
        "eval": {**evals("warm", WARM, out), **evals("tracked", TRACKED, out)},
        "offline": {f"offline_{tag}": [
            PY, "scripts/train_offline_score.py", "--artifacts", art, "--val_root",
            PACKED.format("val"), "--init", TRACKED, "--out",
            os.path.join(out, "offline.jsonl")] for tag, art in (("warm", WARM),
                                                                  ("tracked", TRACKED))},
    }


JAX_LEARNED_NUT = (37, 45)  # task successes, objects: logs/eval_matrix_r5.jsonl, seeds 0-2


def tally(out: str, tag: str) -> dict:
    """A set's four tallies summed over the seeds' logs."""
    total = {}
    for s in SEEDS:
        with open(os.path.join(out, f"eval_{tag}_seed{s}.log")) as f:
            line = [ln for ln in f if ln.startswith("num_objects=")][-1]
        for k, v in re.findall(r"(\w+)=(\d+)", line):
            total[k] = total.get(k, 0) + int(v)
    return total


def band(succ: int, objects: int, rate: float) -> dict:
    """``succ`` of ``objects`` against ``rate``: within 2 binomial SD?"""
    mean = objects * rate
    sd = math.sqrt(objects * rate * (1 - rate))
    return {"expected": mean, "sd": sd, "z": (succ - mean) / sd if sd else 0.0,
            "inside": abs(succ - mean) <= 2 * sd}


def verdict(out: str) -> dict:
    warm, tracked = tally(out, "warm"), tally(out, "tracked")
    n, k = warm["num_objects"], warm["num_task_grasp_succ"]
    return {"warm": warm, "tracked": tracked,
            "warm_vs_jax": band(k, n, JAX_LEARNED_NUT[0] / JAX_LEARNED_NUT[1]),
            "warm_vs_tracked": band(k, n, tracked["num_task_grasp_succ"]
                                    / tracked["num_objects"]),
            "tracked_vs_jax": band(tracked["num_task_grasp_succ"], tracked["num_objects"],
                                   JAX_LEARNED_NUT[0] / JAX_LEARNED_NUT[1])}


def run_stage(name: str, procs: dict, out: str) -> dict:
    """Start every process of a stage, wait for all; one JSON line."""
    t0 = time.perf_counter()
    running = {}
    for tag, cmd in procs.items():
        log = open(os.path.join(out, f"{tag}.log"), "w")
        running[tag] = (subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT),
                        log, time.perf_counter())
    rcs, walls = {}, {}
    for tag, (p, log, t1) in running.items():
        rcs[tag] = p.wait()
        walls[tag] = time.perf_counter() - t1
        log.close()
    row = {"stage": name, "wall_s": time.perf_counter() - t0, "rc": rcs, "proc_s": walls}
    print(json.dumps(row), flush=True)
    with open(os.path.join(out, "stages.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/train_loop")
    ap.add_argument("--stages", default="generate,pack,train,calibrate,eval,offline,verdict")
    ap.add_argument("--max_seconds", type=float, default=600.0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    plan = stages(args)
    for name in args.stages.split(","):
        if name == "verdict":
            v = verdict(args.out)
            print(json.dumps({"verdict": v}), flush=True)
            with open(os.path.join(args.out, "stages.jsonl"), "a") as f:
                f.write(json.dumps({"verdict": v}) + "\n")
            if v["warm_vs_jax"]["inside"] and v["warm_vs_tracked"]["inside"]:
                continue
            name, procs, sets = "swap", {}, swap_sets()
            for tag, d in sets.items():
                procs.update(evals(tag, d, args.out))
        else:
            procs = plan[name]
        row = run_stage(name, procs, args.out)
        if any(rc != 0 for rc in row["rc"].values()):
            sys.exit(f"stage {name} failed: {row['rc']}")
        if name == "swap":
            swaps = {tag: tally(args.out, tag) for tag in sets}
            print(json.dumps({"swaps": swaps}), flush=True)
            with open(os.path.join(args.out, "stages.jsonl"), "a") as f:
                f.write(json.dumps({"swaps": swaps}) + "\n")


if __name__ == "__main__":
    main()
