"""Paired pick protocol, port half: replays the JAX records of
``scripts/paired_pick_jax.py`` through the port's ``execute_pick_arm`` and
says, attempt by attempt, whether the port parts from JAX sooner or more
often than JAX parts from itself.

Each record (``logs/paired_pick/*.npz``) is restored through
``sim/snapshot.py:scene_from_record`` with the eval's fixture params, and
the port runs the eval's 320-waypoint pick three ways:

- ``kin``: JAX's kinematic schedule, held against JAX's ``kin`` run;
- ``dyn``: JAX's dynamicized schedule, held against JAX's ``dyn`` run;
- ``dynp``: the port's own ``dynamicize_schedule`` of the kinematic
  schedule (the handoff of ``--arm_dynamics 1``), held against JAX's ``dyn``.

The chaos floor is JAX against itself: its ``dyn`` run against the same
schedule from positions nudged 1e-6 m.  One JSON line an attempt, then one
summary line a (group, run, device): the discordant picks ``a`` (JAX picked,
the port did not) and ``b`` (the reverse) with the exact McNemar p, the
floor's counts, and the median step at which the target's position first
parts from JAX's by more than 1e-4 m beside the floor's.  A fault is shown
where McNemar p < 0.05 or the port's discordance exceeds the floor's by more
than 2 binomial SD.

    python scripts/paired_pick_protocol.py --out chiprun_out/paired_pick_cuda.jsonl
    python scripts/paired_pick_protocol.py --device cpu --out logs/paired_pick/port_cpu.jsonl
    # shards side by side, then the summary of their lines:
    python scripts/paired_pick_protocol.py --shard 0/4 --out a0.jsonl  # ... 3/4
    python scripts/paired_pick_protocol.py --summarize a0.jsonl a1.jsonl ... --out all.jsonl
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.device import resolve_device, sync
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from catgrasp_tpu_torch.sim import arm as simarm
from catgrasp_tpu_torch.sim import snapshot

PART_M = 1e-4  # a trajectory has parted from JAX's once the target is this far off
W_TOL = 2e-4  # closing widths agree within this (m)
RUNS = {"kin": "kin", "dyn": "dyn", "dynp": "dyn"}  # port run -> the JAX run it is held to


def part_step(a: np.ndarray, b: np.ndarray, tol: float = PART_M) -> int:
    """The first step at which two (T, 3) trajectories are more than ``tol``
    apart; T where they never are."""
    far = np.linalg.norm(a - b, axis=-1) > tol
    return int(np.argmax(far)) if far.any() else len(a)


def mcnemar_p(a: int, b: int) -> float:
    """Two-sided exact McNemar p of discordant counts a and b."""
    n = a + b
    if n == 0:
        return 1.0
    k = min(a, b)
    return min(1.0, 2.0 * sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n)


_SCENES: dict = {}


def scene_of(rec: dict, device) -> rgs.EvalScene:
    """The eval's set-up for a record's class and mesh (one a process)."""
    key = (str(rec["class_name"]), str(rec["obj_path"]), int(rec["n_objects"]))
    if key not in _SCENES:
        _SCENES[key] = rgs.setup_scene(key[0], n_objects=key[2],
                                       cfg_run=load_config("config_run.yml"),
                                       device=device, obj_path=key[1] or None)
    return _SCENES[key]


def restore(sc: rgs.EvalScene, rec: dict):
    """The record's scene on the scene's device, with the eval's fixture
    params as JAX ran it."""
    state, params = snapshot.scene_from_record(rec, sc.lib)
    dev = sc.device

    def t(k):
        return torch.as_tensor(rec[k], dtype=torch.float32, device=dev)

    return state, params.replace(mass=t("mass"), inertia=t("inertia"), friction=t("friction"))


def port_pick(sc: rgs.EvalScene, state, params, target: int, sched: torch.Tensor,
              rec: dict) -> dict:
    trace: list = []
    picked, _, oig, w, c, disturb = simarm.execute_pick_arm(
        sc.lib, state, params, sc.env_bin, target, sched,
        torch.as_tensor(sc.base_in_world, device=sc.device),
        torch.as_tensor(sc.gripper.ee_in_grasp, device=sc.device), sc.gripper.spec,
        n_app=int(rec["n_app"]), n_close=int(rec["n_close"]), n_hold=int(rec["n_hold"]),
        narrowphase=sc.geometry, trace=trace)
    return dict(picked=bool(picked), w_f=float(w), c_f=float(c), disturb=float(disturb),
                ob_in_grasp=oig.cpu().numpy(), traj=torch.stack(trace).cpu().numpy())


def replay(path: str, device, runs=tuple(RUNS)) -> dict:
    """One record through the port's ``runs``: a JSON-ready row."""
    rec = dict(np.load(path))
    sc = scene_of(rec, device)
    state, params = restore(sc, rec)
    target = int(rec["target"])
    dev = sc.device
    kin = torch.as_tensor(rec["sched_kin"], device=dev)
    scheds = {"kin": kin, "dyn": torch.as_tensor(rec["sched_dyn"], device=dev)}
    row = dict(record=os.path.basename(path), class_name=str(rec["class_name"]),
               group=("demo_" if str(rec["obj_path"]) else "") + str(rec["class_name"]),
               device=dev.type, seed=int(rec["seed"]), target=target,
               quat0_err=float(np.abs(state.quat.cpu().numpy() - rec["quat0"]).max()),
               floor_part=part_step(rec["dyn_traj"], rec["nudge_traj"]),
               floor_picked=bool(rec["nudge_picked"]), floor_w_f=float(rec["nudge_w_f"]))
    if "dynp" in runs:
        t0 = time.perf_counter()
        scheds["dynp"] = simarm.dynamicize_schedule(kin)
        sync(dev)
        row.update(dynamicize_s=round(time.perf_counter() - t0, 3), dynp_sched_err=float(
            np.abs(scheds["dynp"].cpu().numpy() - rec["sched_dyn"]).max()))
    for run in runs:
        jrun = RUNS[run]
        t0 = time.perf_counter()
        p = port_pick(sc, state, params, target, scheds[run], rec)
        row[run] = dict(
            picked=p["picked"], jax_picked=bool(rec[f"{jrun}_picked"]),
            w_f=p["w_f"], jax_w_f=float(rec[f"{jrun}_w_f"]), c_f=p["c_f"],
            jax_c_f=float(rec[f"{jrun}_c_f"]), disturb=p["disturb"],
            jax_disturb=float(rec[f"{jrun}_disturb"]),
            part=part_step(p["traj"], rec[f"{jrun}_traj"]),
            max_dev_m=float(np.linalg.norm(p["traj"] - rec[f"{jrun}_traj"], axis=-1).max()),
            oig_t_err_m=float(np.linalg.norm(p["ob_in_grasp"][:3, 3]
                                             - rec[f"{jrun}_ob_in_grasp"][:3, 3])),
            s=round(time.perf_counter() - t0, 2))
    return row


def horizon_breaches(row: dict, run: str = "dyn") -> list:
    """What breaks the horizon check of one replayed run: the target's
    trajectory must stay within ``PART_M`` of JAX's up to the record's floor
    horizon (the step at which JAX parts from its nudged self); where JAX's
    pick agrees with its nudged self's, ``picked`` must equal JAX's, and
    where JAX's width does, the width must lie within ``W_TOL`` of it."""
    r, out = row[run], []
    if r["part"] < row["floor_part"]:
        out.append(f"parted from JAX at step {r['part']}, before the floor's {row['floor_part']}")
    if row["floor_picked"] == r["jax_picked"] and r["picked"] != r["jax_picked"]:
        out.append(f"picked {r['picked']}, JAX {r['jax_picked']}")
    if abs(row["floor_w_f"] - r["jax_w_f"]) <= W_TOL and abs(r["w_f"] - r["jax_w_f"]) > W_TOL:
        out.append(f"width {r['w_f']:.5f} m, JAX {r['jax_w_f']:.5f} m")
    return out


def summarize(rows: list) -> list:
    """A line a (group, run, device), pooled demo groups as ``demo``."""
    out = []
    keys = sorted({(r["group"], r["device"]) for r in rows})
    groups = keys + sorted({("demo", d) for g, d in keys if g.startswith("demo_")})
    for group, dev in groups:
        sel = [r for r in rows if r["device"] == dev
               and (r["group"] == group or (group == "demo" and r["group"].startswith("demo_")))]
        n = len(sel)
        # the floor: JAX's dyn run against its nudged self
        af = sum(r["dyn"]["jax_picked"] and not r["floor_picked"] for r in sel)
        bf = sum(r["floor_picked"] and not r["dyn"]["jax_picked"] for r in sel)
        floor_med = float(np.median([r["floor_part"] for r in sel]))
        for run in RUNS:
            a = sum(r[run]["jax_picked"] and not r[run]["picked"] for r in sel)
            b = sum(r[run]["picked"] and not r[run]["jax_picked"] for r in sel)
            # the binomial SD of a discordance rate at the floor's (taken as
            # at least half a pair, so that a floor of 0 still has a width)
            p_floor = max((af + bf) / n, 0.5 / n)
            sd = math.sqrt(p_floor * (1 - p_floor) / n)
            excess = (a + b - af - bf) / n
            p = mcnemar_p(a, b)
            fault = p < 0.05 or excess > 2 * sd
            out.append(dict(
                summary=True, group=group, run=run, device=dev, n=n,
                jax_picked=sum(r[run]["jax_picked"] for r in sel),
                port_picked=sum(r[run]["picked"] for r in sel), a=a, b=b, mcnemar_p=p,
                floor_a=af, floor_b=bf, floor_mcnemar_p=mcnemar_p(af, bf),
                discordance=(a + b) / n, floor_discordance=(af + bf) / n,
                floor_sd=sd, excess_sd=excess / sd,
                median_part=float(np.median([r[run]["part"] for r in sel])),
                floor_median_part=floor_med,
                width_agree=sum(abs(r[run]["w_f"] - r[run]["jax_w_f"]) <= W_TOL for r in sel),
                fault=bool(fault)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", nargs="+", default=["logs/paired_pick/*.npz"],
                    help="record files or globs")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--shard", default="0/1", help="i/n: every n-th record from the i-th")
    ap.add_argument("--out", required=True, help="JSONL: a line an attempt, then summaries")
    ap.add_argument("--summarize", nargs="*", default=None,
                    help="JSONL files of shards: write their rows and summaries to --out")
    args = ap.parse_args(argv)
    if args.summarize is not None:
        rows = [json.loads(line) for f in args.summarize for line in open(f)]
        rows = [r for r in rows if not r.get("summary")]
    else:
        device = resolve_device(args.device)
        i, n = (int(x) for x in args.shard.split("/"))
        paths = sorted({p for g in args.records for p in glob.glob(g)})[i::n]
        if not paths:
            raise SystemExit(f"no records match {args.records}")
        rows = []
        for path in paths:
            rows.append(replay(path, device))
            print(json.dumps(rows[-1]), flush=True)
    summaries = summarize(rows)
    with open(args.out, "w") as f:
        for r in rows + summaries:
            f.write(json.dumps(r) + "\n")
    for s in summaries:
        print(json.dumps(s))


if __name__ == "__main__":
    main()
