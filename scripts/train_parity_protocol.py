"""Paired training protocol, port half: the port's trainer run from the
tracked nut nets on one packed split, step by step as JAX's trainer runs it
(``scripts/train_parity_jax.py``), and the comparison of two runs.

Both halves read the same packed split, start from the same tracked export
(``artifacts_tracked/nut/<net>/best_val.ckpt``, through each package's
``--init_params`` path), and draw the same batches: batching and
augmentation are seeded numpy in both packages (``data/packed.py``).  The
grasp net's dropout masks are the one draw the two packages cannot share
(``jax.random`` against torch's generators), so both halves carry the same
numpy masks in: a fresh one for each training step, and one fixed mask for
every val batch, as JAX's ``evaluate`` draws every val batch's mask from
``PRNGKey(0)``.  Everything else is each package's own ``Trainer.fit`` with
the net's config: the schedule with its real ``warmup_steps``, the per-epoch
val, ``best_val`` and the plateau revert.

A run writes one JSON line a net: the loss and learning rate of every step,
the train and val loss of every epoch, the ``best_val`` epoch, and the path
of its final parameters (an ``.npz`` beside the checkpoints).  The floor is
a run from the tracked parameters nudged by 1e-6 relative (``--nudge 1``),
held against the same run unnudged; ``--compare`` holds two runs' records
against each other and against a floor:

- the same ``best_val`` epoch;
- every epoch's val loss within max(2 x the floor's difference at that
  epoch, 1e-3) relative;
- beside these, each step's loss and learning rate, and the final
  parameters' relative L2 difference.

    # the split (the port's generate_pile_data + pack_training_data):
    python scripts/train_parity_protocol.py --make_split dataset/torch/parity --device cpu
    # the port's runs, on the CPU and on the card:
    python scripts/train_parity_protocol.py --split dataset/torch/parity --device cpu \\
        --run port_cpu --out logs/train_parity/port_cpu.jsonl
    python scripts/train_parity_protocol.py --split dataset/torch/parity --run port_cuda \\
        --out logs/train_parity/port_cuda.jsonl          # and --nudge 1 for the floor
    # a comparison (A against B, with the floor F against B's run):
    python scripts/train_parity_protocol.py --compare logs/train_parity/port_cpu.jsonl \\
        logs/train_parity/jax_cpu.jsonl --floor logs/train_parity/jax_cpu_nudged.jsonl \\
        --out logs/train_parity/compare_cpu.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

NETS = ("seg", "nunocs", "grasp")
CONFIGS = {"seg": "config_seg.yml", "nunocs": "config_nunocs.yml", "grasp": "config_grasp.yml"}
# The batch of each net, cut from the trainers' (seg 4, train_seg's
# command-line default; NUNOCS 34; grasp 240) so that one JAX run of 60
# steps on 8 host cores takes ~15 min: a JAX step there took 45-56 s (seg),
# 26-28 s (NUNOCS) and 31-32 s (grasp).
BATCH = {"seg": 1, "nunocs": 12, "grasp": 64}
MIN_STEPS, MIN_EPOCHS = 60, 3
TRACKED = "artifacts_tracked/nut/{net}/best_val.ckpt"
NUDGE = 1e-6  # the floor's relative nudge of every parameter
DROP_SEED = 14  # the numpy seed of the carried dropout masks
DROP_WIDTH = 512  # the grasp net's dropout acts on its 512-wide layer
VAL_REL = 1e-3  # the val band's least width (relative)
SPLIT_SCENES = {"train": 24, "val": 8}
SPLIT_SEEDS = {"train": 0, "val": 1}
OUT_ROOT = "artifacts_torch/train_parity"


# ---- what both halves share ------------------------------------------------


def n_epochs_for(steps_per_epoch: int) -> int:
    """Epochs enough for ``MIN_STEPS`` steps, and at least ``MIN_EPOCHS``
    (two epoch ends with a val pass before the last)."""
    return max(MIN_EPOCHS, math.ceil(MIN_STEPS / max(steps_per_epoch, 1)))


def nudge(name: str, value: np.ndarray) -> np.ndarray:
    """``value`` x (1 + 1e-6 z), z standard normal from a generator seeded
    by the leaf's path: the same nudge in both packages."""
    z = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(value.shape)
    return (value * (1.0 + NUDGE * z)).astype(value.dtype)


def nudged_tree(tree: dict, prefix: str = "") -> dict:
    """A parameter tree with every leaf ``nudge``d by its path."""
    return {k: nudged_tree(v, f"{prefix}{k}/") if isinstance(v, dict)
            else nudge(prefix + k, np.asarray(v)) for k, v in tree.items()}


def drop_mask(step: int, batch: int, keep: float) -> np.ndarray:
    """The grasp net's keep mask (batch, 512) for training step ``step``;
    ``step`` -1 is the one mask of every val batch."""
    rng = np.random.default_rng([DROP_SEED, step + 1])
    return rng.random((batch, DROP_WIDTH)) < keep


class MaskedBatches:
    """A trainer's ``train_data``: the dataset's batches, each with the keep
    mask of its training step (``drop_mask``) under ``"drop_mask"``."""

    def __init__(self, batches, batch: int, keep: float):
        self.batches, self.batch, self.keep, self.step = batches, batch, keep, 0

    def __call__(self):
        for b in self.batches():
            b = dict(b, drop_mask=drop_mask(self.step, self.batch, self.keep))
            self.step += 1
            yield b


def flat(tree: dict, prefix: str = "") -> dict:
    """A nested parameter tree as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def epochs_of(metrics_path: str) -> list:
    """The trainer's epoch events (both packages write the same lines)."""
    rows = []
    with open(metrics_path) as f:
        for line in f:
            e = json.loads(line)
            if e["kind"] == "epoch":
                rows.append({"epoch": e["epoch"], "train_loss": e["train_loss"],
                             "val_loss": e.get("val_loss"),
                             "plateau_lr_scale": e.get("plateau_restart_lr_scale")})
    return rows


def best_val_epoch(epochs: list) -> int:
    """The epoch whose parameters ``best_val.ckpt`` holds: the first strict
    minimum of the val loss, as the trainers keep it."""
    best, at = math.inf, -1
    for e in epochs:
        if e["val_loss"] < best:
            best, at = e["val_loss"], e["epoch"]
    return at


def record(net: str, run: str, package: str, device: str, nudged: bool, batch: int,
           n_pts: int, spe: int, n_epochs: int, steps: list, epochs: list, params: dict,
           params_path: str, seconds: float, extra: dict | None = None) -> dict:
    """One net's JSON line; the final parameters go to ``params_path``."""
    os.makedirs(os.path.dirname(params_path), exist_ok=True)
    np.savez(params_path, **params)
    return {"net": net, "run": run, "package": package, "device": device, "nudged": nudged,
            "batch": batch, "n_pts": n_pts, "steps_per_epoch": spe, "n_epochs": n_epochs,
            "n_steps": len(steps), "loss": [s[0] for s in steps], "lr": [s[1] for s in steps],
            "epochs": epochs, "best_val_epoch": best_val_epoch(epochs),
            "params": params_path, "seconds": seconds, **(extra or {})}


# ---- the port's run --------------------------------------------------------


def split_paths(split: str) -> tuple:
    return os.path.join(split, "packed_train"), os.path.join(split, "packed_val")


def make_split(out: str, device, n_train: int = SPLIT_SCENES["train"],
               n_val: int = SPLIT_SCENES["val"], cfg: dict | None = None, **gen_kw) -> dict:
    """The protocol's split: ``generate_scenes`` (nut, the train objects,
    seeds 0 and 1) and ``pack_split`` against the tracked grasp DBs, into
    ``out/{train,val}`` and ``out/packed_{train,val}``."""
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
    from catgrasp_tpu_torch.pipelines import pack_training_data as ptd

    dbs = ptd.load_grasp_dbs("nut")
    metas = {}
    for split, n in (("train", n_train), ("val", n_val)):
        t0 = time.perf_counter()
        gpd.generate_scenes("nut", "train", n, os.path.join(out, split), cfg=cfg,
                            seed=SPLIT_SEEDS[split], device=device, **gen_kw)
        t1 = time.perf_counter()
        meta = packed.pack_split(os.path.join(out, split), os.path.join(out, f"packed_{split}"),
                                 grasp_db=dbs, seed=SPLIT_SEEDS[split], log_every=0)
        metas[split] = dict(meta, generate_s=t1 - t0, pack_s=time.perf_counter() - t1)
        print(f"split {split}: {json.dumps(metas[split])}", flush=True)
    return metas


def port_net(net: str, batch: int | None = None, n_pts: int | None = None,
             cfg_overrides: dict | None = None):
    """(cfg, model, loss_fn, packed dataset class) of a net as its trainer
    builds them."""
    from catgrasp_tpu_torch.config.loader import load_config
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs, train_seg

    cfg = load_config(CONFIGS[net])
    cfg["batch_size"] = batch or BATCH[net]
    if n_pts:
        cfg["n_pts"] = n_pts
    cfg.update(cfg_overrides or {})
    model, loss_fn = {"seg": lambda: train_seg.build(cfg),
                      "nunocs": lambda: train_nunocs.build(cfg, "nut"),
                      "grasp": lambda: train_grasp.build(cfg)}[net]()
    data = {"seg": packed.PackedSeg, "nunocs": packed.PackedNunocs,
            "grasp": packed.PackedGrasp}[net]
    return cfg, model, loss_fn, data


def carry_dropout(model, loss_fn, keep: float, val_mask: np.ndarray):
    """The grasp net with its dropout draw replaced by the carried mask:
    the 512-wide layer's output becomes where(mask, h / keep, 0), as flax's
    ``Dropout`` applies its mask; a batch without ``"drop_mask"`` (a val
    batch) takes ``val_mask``.  Returns the loss to train with."""
    held = {}
    model.dropout = 0.0
    model.MLPStack_0.register_forward_hook(
        lambda _m, _i, h: torch.where(held["mask"], h / keep, torch.zeros_like(h))
        if held.get("mask") is not None else h)

    def loss(model_, batch, train):
        batch = dict(batch)
        mask = batch.pop("drop_mask", None)
        if mask is None:
            mask = torch.as_tensor(val_mask, device=batch["x"].device)
        held["mask"] = mask if train else None
        try:
            return loss_fn(model_, batch, train)
        finally:
            held["mask"] = None

    return loss


def run_port(net: str, split, device, run: str, nudged: bool = False,
             out_root: str = OUT_ROOT, batch: int | None = None, n_pts: int | None = None,
             n_epochs: int | None = None, cfg_overrides: dict | None = None,
             steps: int | None = None) -> dict:
    """One net's paired run through the port's ``Trainer.fit``; returns its
    record (``record``).  ``split`` is a ``make_split`` directory or a
    (train, val) pair of packed directories; ``steps`` bounds the train
    batches of an epoch and the val batches."""
    from itertools import islice

    from catgrasp_tpu_torch import convert
    from catgrasp_tpu_torch.train import trainer as T

    dev = torch.device(device)
    cfg, model, loss_fn, data = port_net(net, batch, n_pts, cfg_overrides)
    bs = cfg["batch_size"]
    train_root, val_root = split_paths(split) if isinstance(split, str) else split
    ds = data(train_root, cfg)
    val = data(val_root, cfg) if net == "seg" else data(val_root, cfg, phase="val")
    spe = max(len(ds) // bs, 1)
    n_epochs = n_epochs or n_epochs_for(len(ds) // bs)
    state = T.create_state(model, cfg, spe, device=dev)
    state, _ = T.start_state(state, init_params=TRACKED.format(net=net))
    if nudged:  # in flax's layouts, leaf by leaf as the JAX half nudges
        tree = convert.flax_params(model.state_dict())
        model.load_state_dict(convert.flax_state_dict(nudged_tree(tree)))
    train_data = lambda: islice(ds.batches(bs), steps)  # noqa: E731
    if net == "grasp":
        keep = 1.0 - model.dropout
        loss_fn = carry_dropout(model, loss_fn, keep, drop_mask(-1, bs, keep))
        train_data = MaskedBatches(train_data, bs, keep)

    trace = []  # (loss, learning rate) a step
    make = T.make_train_step

    def recording(loss, mesh=None):
        step = make(loss, mesh)

        def run_step(state, batch):
            state, l, aux = step(state, batch)
            trace.append((float(l), float(state.tx.opt.param_groups[0]["lr"])))
            return state, l, aux

        return run_step

    ckpt_dir = os.path.join(out_root, run, net)
    trainer = T.Trainer(model=model, cfg=cfg, loss_fn=loss_fn, train_data=train_data,
                        val_data=lambda: islice(val.batches(bs, shuffle=False), steps),
                        ckpt_dir=ckpt_dir)
    if os.path.exists(os.path.join(ckpt_dir, "metrics.jsonl")):
        os.remove(os.path.join(ckpt_dir, "metrics.jsonl"))
    t0 = time.perf_counter()
    T.make_train_step = recording
    try:
        state = trainer.fit(state, n_epochs=n_epochs, verbose=False)
    finally:
        T.make_train_step = make
    seconds = time.perf_counter() - t0
    params = flat(convert.flax_params(state.model.state_dict()))
    return record(net, run, "port", str(dev), nudged, bs, cfg["n_pts"], spe, n_epochs, trace,
                  epochs_of(os.path.join(ckpt_dir, "metrics.jsonl")), params,
                  os.path.join(ckpt_dir, "final_params.npz"), seconds,
                  {"torch": torch.__version__})


# ---- the comparison --------------------------------------------------------


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over every parameter of two {name: array} maps."""
    if sorted(a) != sorted(b):
        raise ValueError("two parameter sets with other leaves")
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return math.sqrt(num / den)


def param_rel_l2(path_a: str, path_b: str) -> float:
    """``rel_l2`` of two runs' final parameters."""
    return rel_l2(dict(np.load(path_a)), dict(np.load(path_b)))


def diff(a: dict, b: dict) -> dict:
    """Run ``a`` against run ``b`` of the same net: step by step, epoch by
    epoch, and the final parameters."""
    n = min(a["n_steps"], b["n_steps"])
    loss = [rel(x, y) for x, y in zip(a["loss"][:n], b["loss"][:n])]
    lr = [rel(x, y) for x, y in zip(a["lr"][:n], b["lr"][:n])]
    val = [rel(x["val_loss"], y["val_loss"]) for x, y in zip(a["epochs"], b["epochs"])]
    return {"n_steps": [a["n_steps"], b["n_steps"]], "n_epochs": [len(a["epochs"]),
                                                                  len(b["epochs"])],
            "loss_rel_max": max(loss), "loss_rel_median": float(np.median(loss)),
            "loss_rel_last": loss[-1], "lr_rel_max": max(lr), "val_rel": val,
            "best_val_epoch": [a["best_val_epoch"], b["best_val_epoch"]],
            "plateau_epochs": [[e["epoch"] for e in r["epochs"] if e["plateau_lr_scale"]]
                               for r in (a, b)],
            "param_rel_l2": param_rel_l2(a["params"], b["params"])}


def compare(a: dict, b: dict, floor: dict) -> dict:
    """``a`` against ``b`` with ``floor`` (``b``'s nudged run) against ``b``:
    the verdict of the protocol's two criteria."""
    d, f = diff(a, b), diff(floor, b)
    band = [max(2 * x, VAL_REL) for x in f["val_rel"]]
    breaches = []
    if d["n_steps"][0] != d["n_steps"][1] or d["n_epochs"][0] != d["n_epochs"][1]:
        breaches.append(f"runs of different length: {d['n_steps']} steps, "
                        f"{d['n_epochs']} epochs")
    if d["best_val_epoch"][0] != d["best_val_epoch"][1]:
        breaches.append(f"best_val epoch {d['best_val_epoch'][0]} against "
                        f"{d['best_val_epoch'][1]}")
    for e, (x, w) in enumerate(zip(d["val_rel"], band)):
        if x > w:
            breaches.append(f"epoch {e}: val loss {x:.3e} relative apart, band {w:.3e}")
    return {"net": b["net"], "a": a["run"], "b": b["run"], "floor": floor["run"], **d,
            "floor_diff": f, "val_band": band, "ok": not breaches, "breaches": breaches}


def load_records(path: str) -> dict:
    with open(path) as f:
        return {r["net"]: r for r in map(json.loads, f) if "net" in r and "loss" in r}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--make_split", default=None, help="write the split into this directory")
    ap.add_argument("--split", default=None, help="the split to train on")
    ap.add_argument("--nets", default=",".join(NETS))
    ap.add_argument("--device", default=None, help="default the GPU")
    ap.add_argument("--run", default=None, help="the run's name (default port_<device>)")
    ap.add_argument("--nudge", type=int, default=0, help="1: start 1e-6 relative off")
    ap.add_argument("--out_root", default=OUT_ROOT, help="checkpoints and final parameters")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"),
                    help="two runs' record files: A held against B")
    ap.add_argument("--floor", default=None, help="B's nudged run (with --compare)")
    ap.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = ap.parse_args(argv)

    from catgrasp_tpu_torch.device import resolve_device

    rows = []
    if args.compare:
        a, b = (load_records(p) for p in args.compare)
        floor = load_records(args.floor)
        rows = [compare(a[n], b[n], floor[n]) for n in b if n in a and n in floor]
    elif args.make_split:
        dev = resolve_device(args.device)
        rows = [{"split": args.make_split, "device": str(dev),
                 **make_split(args.make_split, dev)}]
    else:
        dev = resolve_device(args.device)
        if dev.type == "cpu":  # one thread a core this process may run on
            torch.set_num_threads(len(os.sched_getaffinity(0)))
        run = args.run or f"port_{dev.type}" + ("_nudged" if args.nudge else "")
        for net in args.nets.split(","):
            rows.append(run_port(net, args.split, dev, run, bool(args.nudge), args.out_root))
            r = rows[-1]
            print(f"{run} {net}: {r['n_steps']} steps, {len(r['epochs'])} epochs, val "
                  f"{[round(e['val_loss'], 6) for e in r['epochs']]}, best_val epoch "
                  f"{r['best_val_epoch']}, {r['seconds']:.1f} s", flush=True)
    for r in rows:
        if "ok" in r:
            print(f"{r['a']} against {r['b']} [{r['net']}]: ok {r['ok']}; val rel "
                  f"{['%.2e' % x for x in r['val_rel']]} (floor "
                  f"{['%.2e' % x for x in r['floor_diff']['val_rel']]}); best_val "
                  f"{r['best_val_epoch']}; step loss rel max {r['loss_rel_max']:.2e}; "
                  f"params rel L2 {r['param_rel_l2']:.2e} (floor "
                  f"{r['floor_diff']['param_rel_l2']:.2e}) {'; '.join(r['breaches'])}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
