"""Net training through the port's ``Trainer.fit``: the driver of the mixes
whose ``driver`` is ``train``.

Set-up writes a packed split from the seed (``traffic/<mix>.json`` gives
its sizes; rows made on the device in a few calls, written under
``TMPDIR``), builds the net and its loss as the training pipeline of
``mix["net"]`` builds them, gives the net weights made on the device from
the seed, and drives that same trainer through its first three steps in
one ``fit`` call of one epoch, its evaluation and checkpoints included:
that warms every shape of the window.  The window is one ``fit`` call
bounded by ``max_seconds=--seconds``, from the next epoch on, with torch's
generator seeded anew.  Once the window has closed, the plain reference
follows the set-up's three steps from the seed, and the window's first two
from the program's state at the window's start (its parameters and Adam's
moments, copied to the host at the end of the set-up); the program's loss
at each of those steps is kept as it computed it, a device scalar read
after the window.

The harness's feed wraps the dataset's batch iterator: it times the host's
wait inside it, records a CUDA event as it hands over each batch (the
interval between two events' completions is a step as the device ran it,
stalls included) and, with ``--trace 1``, runs the window's steps
``[a, b)`` under a device-only profiler and ``[b, c)`` under one that adds
the host's operators, for ``(a, b, c) = mix["profile_steps"]``."""
from __future__ import annotations

import gc
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from ..harness import Cell, Result
from ..reference import training as reference
from ..yardstick import compare, flops, peaks, stats
from ..yardstick.trace import Window, device_record, traced_summary

REF_STEPS = 3  # the set-up's steps the reference follows
WINDOW_STEPS = 2  # and the window's first steps, from its start
_STN_HEAD = re.compile(r"(^|\.)STN_\d+\.Dense_0\.weight$")


# --------------------------------------------------------------------------
# the split
# --------------------------------------------------------------------------


def _rotations(gen, n, dev):
    q = torch.randn((n, 4), generator=gen, device=dev)
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).T
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       dim=-1).reshape(n, 3, 3)


def _unit(gen, shape, dev):
    v = torch.randn(shape, generator=gen, device=dev)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _f16(t: torch.Tensor, path: str) -> None:
    t.to(torch.float16).cpu().numpy().tofile(path)


def write_grasp_split(out: str, part: dict, pts: int, gen, dev) -> None:
    """Scene clouds (xyz in a 0.3 x 0.3 x 0.2 m box, unit normals) and
    grasp keys: a random rotation at a random point of its cloud, a score
    uniform in [0, 1), ``keys / clouds`` keys a cloud."""
    n_c, n_k = part["clouds"], part["keys"]
    xyz = torch.rand((n_c, pts, 3), generator=gen, device=dev) * torch.tensor(
        [0.3, 0.3, 0.2], device=dev) + torch.tensor([-0.15, -0.15, 0.4], device=dev)
    _f16(torch.cat([xyz, _unit(gen, (n_c, pts, 3), dev)], -1), os.path.join(out, "grasp_cloud.bin"))
    row = torch.arange(n_k, device=dev) // (n_k // n_c)
    at = torch.randint(0, pts, (n_k,), generator=gen, device=dev)
    pose = torch.zeros((n_k, 4, 4), device=dev)
    pose[:, :3, :3] = _rotations(gen, n_k, dev)
    pose[:, :3, 3] = xyz[row, at]
    pose[:, 3, 3] = 1.0
    np.savez(os.path.join(out, "grasp_keys.npz"), pose=pose.cpu().numpy(),
             score=torch.rand(n_k, generator=gen, device=dev).cpu().numpy(),
             cloud_row=row.cpu().numpy().astype(np.int64))
    _meta(out, n_grasp_cloud=n_c, grasp_scene_pts=pts, n_grasp_keys=n_k)


def write_nunocs_split(out: str, part: dict, pts: int, gen, dev) -> None:
    """Object rows: xyz in a 6 cm box about a random centre, unit normals,
    NUNOCS coordinates uniform in the unit cube."""
    n = part["rows"]
    xyz = (torch.rand((n, pts, 3), generator=gen, device=dev) - 0.5) * 0.06 \
        + torch.rand((n, 1, 3), generator=gen, device=dev) * 0.2
    rows = torch.cat([xyz, _unit(gen, (n, pts, 3), dev),
                      torch.rand((n, pts, 3), generator=gen, device=dev)], -1)
    _f16(rows, os.path.join(out, "nunocs.bin"))
    _meta(out, n_nunocs=n, nunocs_pts=pts)


def _meta(out: str, **counts) -> None:
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(counts, f)


WRITERS = {"grasp": write_grasp_split, "nunocs": write_nunocs_split}


def write_splits(root: str, mix: dict, seed: int, dev: torch.device) -> dict:
    """``{"train": dir, "val": dir}`` under ``root``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dirs = {}
    for phase in ("train", "val"):
        dirs[phase] = os.path.join(root, phase)
        os.makedirs(dirs[phase])
        WRITERS[mix["net"]](dirs[phase], mix[phase], mix["row_pts"], gen, dev)
    return dirs


def make_weights(model: torch.nn.Module, seed: int, dev: torch.device) -> dict:
    """Weights from the seed, made on the device in one draw: each matrix
    normal with standard deviation sqrt(1 / fan_in), the spatial
    transformers' last matrices zero (their transforms start at the
    identity), GroupNorm scales 1, every bias 0."""
    named = list(model.named_parameters())
    mats = [(n, p) for n, p in named if p.dim() == 2 and not _STN_HEAD.search(n)]
    flat = torch.randn(sum(p.numel() for _, p in mats), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    out, at = {}, 0
    for n, p in named:
        if p.dim() == 2 and not _STN_HEAD.search(n):
            out[n] = flat[at:at + p.numel()].view(p.shape) / math.sqrt(p.shape[1])
            at += p.numel()
        elif p.dim() == 1 and n.endswith(".weight"):
            out[n] = torch.ones(p.shape, device=dev)
        else:
            out[n] = torch.zeros(p.shape, device=dev)
    return out


# --------------------------------------------------------------------------
# the feed
# --------------------------------------------------------------------------


class Feed:
    """The ``train_data`` callable handed to the trainer.  ``limit`` ends
    the iteration after that many batches; ``hooks[k]`` runs as batch ``k``
    is asked for (steps 0..k-1 have been enqueued then); with ``events``,
    each handed batch gets a CUDA event."""

    def __init__(self, batches):
        self.batches = batches
        self.limit = None
        self.hooks = {}
        self.events = None
        self.n = 0
        self.wait_s = 0.0

    def __call__(self):
        it = self.batches()
        while self.limit is None or self.n < self.limit:
            t = time.perf_counter()
            batch = next(it, None)
            self.wait_s += time.perf_counter() - t
            if batch is None:
                return
            hook = self.hooks.pop(self.n, None)
            if hook is not None:
                hook()
            if self.events is not None:
                self.events.append(_mark())
            self.n += 1
            yield batch


def _mark():
    """A CUDA event recorded on the current stream (on the CPU, the host's
    clock in ms)."""
    if not torch.cuda.is_available():
        return time.perf_counter() * 1e3
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _interval_ms(a, b) -> float:
    return b - a if isinstance(a, float) else a.elapsed_time(b)


class Counted:
    """An iterator factory that counts the batches it hands over."""

    def __init__(self, batches):
        self.batches, self.n = batches, 0

    def __call__(self):
        for batch in self.batches():
            self.n += 1
            yield batch


def _fwd_macs(mix: dict, cfg: dict) -> float:
    if mix["net"] == "grasp":
        return flops.pointnet_macs(cfg["batch_size"], cfg["n_pts"], False, len(cfg["classes"]) - 1)
    return flops.pointnet_macs(cfg["batch_size"], cfg["n_pts"], True, 3 * cfg["ce_loss_bins"])


def reference_readings(cell: Cell, split: str, weights: dict, program: dict,
                       fault: str | None = None, tf32: bool = False,
                       detail: bool = False) -> dict:
    """The numbers compared, of ``program`` against the plain reference's;
    with ``fault`` or ``tf32``, of the reference so planted, or in TF32,
    put in the program's place.  ``program`` holds the set-up's ``losses``,
    ``first_grad`` and ``params`` after its steps, the window's start
    (``start``: the optimizer's moments and step count) and the window's
    first ``window_losses``.

    Compared: the set-up's first loss, the worst leaf's first gradient, the
    median leaf's change over the set-up's steps (the leaves that move),
    and the window's losses.  With ``detail``, also what is not compared:
    the gap of every step's loss, the worst leaf's change and the worst
    leaves."""
    cfg, mix = cell.config["net"], cell.mix
    run = dict(net=mix["net"], cfg=cfg, class_name=cell.config["class_name"], split_dir=split,
               device=cell.device)
    setup = dict(params=weights, n_steps=REF_STEPS, seed=cell.seed)
    window = dict(params=program["params"], n_steps=WINDOW_STEPS, seed=cell.seed + 1,
                  state=program["start"], after=REF_STEPS)
    ref, ref_w = reference.steps(**run, **setup), reference.steps(**run, **window)
    if fault is not None or tf32:
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            planted = reference.steps(**run, **setup, fault=fault)
            planted["window_losses"] = reference.steps(**run, **window, fault=fault)["losses"]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        program = planted
    w0 = {k: v.cpu() for k, v in weights.items()}
    moving = compare.moving_leaves(ref["first_grad"])
    change, ref_change = compare.change(program["params"], w0), compare.change(ref["params"], w0)
    out = {"first_loss_gap": compare.loss_gap(program["losses"][:1], ref["losses"][:1]),
           "grad_gap": compare.leaf_gap(program["first_grad"], ref["first_grad"]),
           "median_change_gap": compare.median_leaf_gap(change, ref_change, moving),
           "window_loss_gap": compare.loss_gap(program["window_losses"], ref_w["losses"])}
    if detail:
        out["loss_gap"] = compare.loss_gap(program["losses"], ref["losses"])
        out["change_gap"] = compare.leaf_gap(change, ref_change, moving)
        out["step_loss_gaps"] = [compare.loss_gap([p], [r]) for p, r in
                                 zip(program["losses"] + program["window_losses"],
                                     ref["losses"] + ref_w["losses"])]
        out["worst_grad_leaves"] = compare.worst_leaves(program["first_grad"], ref["first_grad"])
        out["worst_change_leaves"] = compare.worst_leaves(change, ref_change, moving)
    return out


def run(cell: Cell, keep: dict | None = None) -> Result:
    """One run; ``keep``, when given, receives the split's directory and
    the weights, for readings taken after the run."""
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs
    from catgrasp_tpu_torch.train import trainer as T

    cfg, mix, dev = dict(cell.config["net"]), cell.mix, cell.device
    tmp = tempfile.TemporaryDirectory(prefix="bench_train_")
    try:
        dirs = write_splits(tmp.name, mix, cell.seed, dev)
        if mix["net"] == "grasp":
            model, loss_fn = train_grasp.build(cfg)
            reader = packed.PackedGrasp
        else:
            model, loss_fn = train_nunocs.build(cfg, cell.config["class_name"])
            reader = packed.PackedNunocs
        ds, val = reader(dirs["train"], cfg), reader(dirs["val"], cfg, phase="val")
        bs = cfg["batch_size"]
        state = T.create_state(model, cfg, max(len(ds) // bs, 1), device=dev)
        weights = make_weights(model, cell.seed, dev)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights[n])

        # the first steps, through the window's own call and feed
        losses, snap = [], {}

        def recorded(model, batch, train):
            loss, aux = loss_fn(model, batch, train)
            # a training step, not the evaluation; the set-up's and the window's first
            if torch.is_grad_enabled() and len(losses) < REF_STEPS + WINDOW_STEPS:
                losses.append(loss.detach())
            return loss, aux

        def first_grad():  # Adam's first moment after one step is (1 - b1) g
            moments = state.tx.opt.state
            snap["first_grad"] = {n: (moments[p].get("exp_avg", torch.zeros_like(p))
                                      / (1 - 0.9)).cpu() for n, p in state.tx.named}

        feed, val_feed = Feed(lambda: ds.batches(bs)), Counted(lambda: val.batches(bs, shuffle=False))
        feed.limit, feed.hooks = REF_STEPS, {1: first_grad}
        trainer = T.Trainer(model=model, cfg=cfg, loss_fn=recorded, train_data=feed,
                            val_data=val_feed, ckpt_dir=os.path.join(tmp.name, "ckpt"))
        torch.manual_seed(cell.seed)  # the dropout masks' stream
        state = trainer.fit(state, n_epochs=1)
        if len(losses) < REF_STEPS:
            raise RuntimeError(f"the split holds {len(losses)} batches; the reference "
                               f"follows the first {REF_STEPS}")
        moments = state.tx.opt.state
        program = {"first_grad": snap["first_grad"],
                   "params": {n: p.detach().to("cpu", copy=True)
                              for n, p in model.named_parameters()},
                   "start": {"count": state.tx.count,
                             **{key: {n: moments[p].get(key, torch.zeros_like(p)).to(
                                          "cpu", copy=True) for n, p in state.tx.named}
                                for key in ("exp_avg", "exp_avg_sq")}}}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.monotonic() - cell.t_start

        # the window
        feed.limit, feed.n, feed.wait_s, val_feed.n = None, 0, 0.0, 0
        feed.events = []
        measure, label = Window(), Window(host=True)
        if cell.trace:
            a, b, c = mix["profile_steps"]
            feed.hooks = {a: measure.start, b: lambda: (measure.stop(steps=b - a), label.start()),
                          c: label.stop}
        torch.manual_seed(cell.seed + 1)  # the window's dropout masks
        t0 = time.perf_counter()
        state = trainer.fit(state, max_seconds=cell.seconds, start_epoch=1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for w in (measure, label):  # a window shorter than the traced steps
            if w.running:
                w.stop(steps=feed.n - mix["profile_steps"][0])
        steps = feed.n
        program["losses"] = [float(v) for v in losses[:REF_STEPS]]
        program["window_losses"] = [float(v) for v in losses[REF_STEPS:]]
        device = device_record(1) if dev.type == "cuda" else {"platform": dev.type, "count": 1}
        e2e = {"train_samples_per_s": steps * bs / wall}
        gaps = [_interval_ms(a, b) for a, b in zip(feed.events, feed.events[1:])]
        e2e["train_step_p90_ms"] = stats.p90(gaps)
        print(f"{steps} steps, {len(gaps)} step intervals, "
              f"{stats.beyond(gaps, e2e['train_step_p90_ms'])} beyond the 90th percentile",
              file=sys.stderr)
        with open(os.path.join(tmp.name, "ckpt", "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        failed = sum(not math.isfinite(e["train_loss"]) for e in epochs if "train_loss" in e)
        peak, peak_name = peaks.matmul_peak()
        layer = {"steps": steps, "wall_s": wall, "wait_s": feed.wait_s, "val_batches": val_feed.n,
                 "fwd_macs": _fwd_macs(mix, cfg), "peak_flop_per_s": peak, "peak": peak_name,
                 "trace": traced_summary(measure, label)}

        # the reference, once the program's state is freed
        del trainer, state, model, feed, val_feed, ds, val
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        readings = reference_readings(cell, dirs["train"], weights, program)
        if keep is not None:
            keep.update(split=dirs["train"], weights=weights, program=program, tmp=tmp)
            tmp = None
        return Result(setup_s=setup_s, e2e=e2e, attempted=steps, failed=failed,
                      readings=readings, layer=layer, device=device)
    finally:
        if tmp is not None:
            tmp.cleanup()
