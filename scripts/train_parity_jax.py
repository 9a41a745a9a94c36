"""Paired training protocol, JAX half: JAX's trainer run from the tracked
nut nets on a packed split made by the port, as
``scripts/train_parity_protocol.py`` runs the port's (its docstring says
what is shared and how two runs are compared).

Each net is built as its JAX pipeline builds it, warm-started through
``warm_start_params`` from ``artifacts_tracked/nut/<net>/best_val.ckpt``
(nudged by 1e-6 relative with ``--nudge 1``: the floor), and trained by
JAX's ``Trainer.fit`` with the protocol's batch and epochs.  Two things are
recorded from outside the trainer: each step's loss, and its learning rate,
the schedule of the optimizer JAX's ``make_optimizer`` last built (the
plateau revert builds a new one) at the step's count.  The grasp net's
dropout draws are replaced by the protocol's carried masks: flax's
``Dropout`` runs as it is, with ``random.bernoulli`` returning the mask.
Runs on the CPU (minutes a net):

    JAX_PLATFORMS=cpu python scripts/train_parity_jax.py --split dataset/torch/parity \\
        --out logs/train_parity/jax_cpu.jsonl
    JAX_PLATFORMS=cpu python scripts/train_parity_jax.py --split dataset/torch/parity \\
        --nudge 1 --out logs/train_parity/jax_cpu_nudged.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from scripts import train_parity_protocol as tpp


class CarriedBernoulli:
    """Stands in for ``jax.random`` inside ``flax.linen.stochastic``: its
    ``bernoulli`` returns the carried keep mask (a training batch's, else
    the val mask); everything else is ``jax.random``'s."""

    def __init__(self, random):
        self.random, self.mask = random, None

    def __getattr__(self, name):
        return getattr(self.random, name)

    def bernoulli(self, key, p=0.5, shape=None):
        assert self.mask is not None and tuple(self.mask.shape) == tuple(shape), shape
        return self.mask


def jax_net(net: str, batch: int | None = None, n_pts: int | None = None,
            cfg_overrides: dict | None = None):
    """(cfg, model, loss_fn, packed dataset class) of a net as its JAX
    pipeline builds them."""
    from catgrasp_tpu.config.loader import load_config
    from catgrasp_tpu.data import packed
    from catgrasp_tpu.pipelines import train_grasp, train_nunocs, train_seg

    cfg = load_config(tpp.CONFIGS[net])
    cfg["batch_size"] = batch or tpp.BATCH[net]
    if n_pts:
        cfg["n_pts"] = n_pts
    cfg.update(cfg_overrides or {})
    model, loss_fn = {"seg": lambda: train_seg.build(cfg),
                      "nunocs": lambda: train_nunocs.build(cfg, "nut"),
                      "grasp": lambda: train_grasp.build(cfg)}[net]()
    data = {"seg": packed.PackedSeg, "nunocs": packed.PackedNunocs,
            "grasp": packed.PackedGrasp}[net]
    return cfg, model, loss_fn, data


def run_jax(net: str, split, run: str, nudged: bool = False,
            out_root: str = tpp.OUT_ROOT, batch: int | None = None, n_pts: int | None = None,
            n_epochs: int | None = None, cfg_overrides: dict | None = None) -> dict:
    """One net's paired run through JAX's ``Trainer.fit``; returns its
    record (``tpp.record``).  ``split`` as ``tpp.run_port`` takes it."""
    import flax.linen.stochastic as stochastic
    import jax
    import jax.numpy as jnp

    from catgrasp_tpu.train import trainer as JT

    cfg, model, loss_fn, data = jax_net(net, batch, n_pts, cfg_overrides)
    bs = cfg["batch_size"]
    train_root, val_root = tpp.split_paths(split) if isinstance(split, str) else split
    ds = data(train_root, cfg)
    val = data(val_root, cfg) if net == "seg" else data(val_root, cfg, phase="val")
    spe = max(len(ds) // bs, 1)
    n_epochs = n_epochs or tpp.n_epochs_for(len(ds) // bs)

    schedule = {}
    make_opt, make_step = JT.make_optimizer, JT.make_train_step

    def recording_optimizer(cfg_, steps_per_epoch):
        schedule["now"] = JT.multistep_lr(cfg_.get("start_lr", 0.01), cfg_.get("batch_size", 32),
                                          cfg_.get("lr_milestones", []), steps_per_epoch,
                                          warmup_steps=cfg_.get("warmup_steps", 0))
        return make_opt(cfg_, steps_per_epoch)

    steps = []

    def recording_step(loss, mesh=None, donate=True):
        step = make_step(loss, mesh, donate)

        def run_step(state, batch, rng):
            lr = schedule["now"](state.opt_state[2][1].count)  # adam: (clip, decay, (adam, sched))
            state, l, aux = step(state, batch, rng)
            steps.append((float(l), float(lr)))
            return state, l, aux

        return run_step

    JT.make_optimizer, JT.make_train_step = recording_optimizer, recording_step
    carried = CarriedBernoulli(stochastic.random)
    stochastic.random = carried
    try:
        # the state as the pipelines' ``create_state`` makes it, its init
        # jitted (the tracked parameters then replace the drawn ones)
        key = jax.random.PRNGKey(0 if net == "seg" else cfg.get("random_seed", 0))
        if net == "seg":  # train_seg's main: one scene's cloud
            n = cfg.get("n_pts", 20000)
            example = (jax.random.uniform(key, (n, 3)) * 0.2, jnp.ones((n, 3)), jnp.zeros(3))
        else:
            example = (jnp.zeros((bs, cfg["n_pts"], cfg.get("input_channel", 6)), jnp.float32),)
        state = JT.TrainState.create(apply_fn=model.apply,
                                     params=jax.jit(model.init)(key, *example)["params"],
                                     tx=JT.make_optimizer(cfg, spe))
        state = JT.warm_start_params(tpp.TRACKED.format(net=net), state)
        if nudged:
            state = state.replace(params=jax.tree.map(
                jnp.asarray, tpp.nudged_tree(jax.tree.map(np.asarray, dict(state.params)))))
        train_data = lambda: ds.batches(bs)  # noqa: E731
        if net == "grasp":
            keep = 1.0 - model.dropout
            val_mask = tpp.drop_mask(-1, bs, keep)
            train_data = tpp.MaskedBatches(train_data, bs, keep)
            inner = loss_fn

            def loss_fn(params, apply_fn, batch, rng):
                batch = dict(batch)
                carried.mask = batch.pop("drop_mask", val_mask)
                return inner(params, apply_fn, batch, rng)

        ckpt_dir = os.path.join(out_root, run, net)
        if os.path.exists(os.path.join(ckpt_dir, "metrics.jsonl")):
            os.remove(os.path.join(ckpt_dir, "metrics.jsonl"))
        trainer = JT.Trainer(model=model, cfg=cfg, loss_fn=loss_fn, train_data=train_data,
                             val_data=lambda: val.batches(bs, shuffle=False), ckpt_dir=ckpt_dir)
        t0 = time.perf_counter()
        state = trainer.fit(state, n_epochs=n_epochs, verbose=False)
        seconds = time.perf_counter() - t0
    finally:
        JT.make_optimizer, JT.make_train_step = make_opt, make_step
        stochastic.random = carried.random
    params = tpp.flat(jax.tree.map(np.asarray, dict(state.params)))
    return tpp.record(net, run, "jax", "cpu", nudged, bs, cfg["n_pts"], spe, n_epochs, steps,
                      tpp.epochs_of(os.path.join(ckpt_dir, "metrics.jsonl")), params,
                      os.path.join(ckpt_dir, "final_params.npz"), seconds,
                      {"jax": jax.__version__})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", required=True, help="a split of --make_split")
    ap.add_argument("--nets", default=",".join(tpp.NETS))
    ap.add_argument("--run", default=None, help="the run's name (default jax_cpu)")
    ap.add_argument("--nudge", type=int, default=0, help="1: start 1e-6 relative off")
    ap.add_argument("--out_root", default=tpp.OUT_ROOT)
    ap.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = ap.parse_args(argv)
    run = args.run or "jax_cpu" + ("_nudged" if args.nudge else "")
    rows = []
    for net in args.nets.split(","):
        r = run_jax(net, args.split, run, bool(args.nudge), args.out_root)
        rows.append(r)
        print(f"{run} {net}: {r['n_steps']} steps, {len(r['epochs'])} epochs, val "
              f"{[round(e['val_loss'], 6) for e in r['epochs']]}, best_val epoch "
              f"{r['best_val_epoch']}, {r['seconds']:.1f} s", flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
