"""The trainer (``catgrasp_tpu/train/trainer.py`` in PyTorch): one GPU, or
data-parallel over a mesh's batch shards (``Trainer.mesh``).

The three nets share one epoch loop: Adam (or SGD), lr = start_lr / 64 x
batch size, x0.1 at each milestone epoch after an optional linear warmup,
per-epoch train and val losses, best-train and best-val checkpoints,
``last.ckpt`` every epoch, a wall-clock bound and the val-plateau restart.

The optimizer is optax's chain as the JAX package builds it, over
``torch.optim``: the gradients clipped by their global norm exactly as
``optax.clip_by_global_norm`` clips (scaled by max_norm / norm where norm
>= max_norm, no epsilon), then ``add_decayed_weights`` and Adam (b1 0.9,
b2 0.999, eps 1e-8) as ``torch.optim.Adam(weight_decay=)`` applies them, or
SGD with momentum 0.9; the learning rate of step k is the schedule at k,
the count before the increment, as optax's ``scale_by_schedule`` reads it.

Checkpoints are the JAX trainer's msgpack files, written and read by the
port's own encoder (``predict/ckpt.py``): ``{params, opt_state, step,
epoch}`` with the parameters as a flax tree (``convert.flax_params``) and
the optimizer's state as flax serializes optax's: for Adam
``{"0": {}, "1": {}, "2": {"0": {count, mu, nu}, "1": {count}}}`` (clip,
decay, then adam's moments and its schedule's count), for SGD
``{"0": {}, "1": {"0": {trace}, "1": {count}}}``.  ``mu``, ``nu`` and
``trace`` are Adam's ``exp_avg``, ``exp_avg_sq`` and SGD's momentum
buffer; Adam's ``count`` is its ``step``.  So a checkpoint of either
package resumes in the other.
"""
from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from .. import convert
from ..nn.init import init_like_flax
from ..parallel.mesh import dp_sharding, split, to_device, tree_map
from ..predict import ckpt
from ..utils import profiling
from ..utils.metrics import MetricsLogger
from ..utils.outputs import refuse_tracked

DEFAULT_CKPT_ROOT = "artifacts_torch"  # the trainers' checkpoints: artifacts_torch/<net>


def multistep_lr(start_lr: float, batch_size: int, milestones: list, steps_per_epoch: int,
                 gamma: float = 0.1, warmup_steps: int = 0) -> Callable[[int], float]:
    """The learning rate at a step count: base = start_lr / 64 x batch,
    x``gamma`` from each ``milestone x steps_per_epoch``; with a warmup, a
    linear ramp from 0.02 base to base over ``warmup_steps``, after which
    the piecewise schedule runs from its own step 0 (optax's
    ``join_schedules``).  In float32, as optax computes it."""
    f32 = np.float32
    base = start_lr / 64.0 * batch_size
    bounds = sorted({m * steps_per_epoch: gamma for m in milestones}.items())

    def piecewise(count: int):
        v = f32(base)
        for threshold, scale in bounds:
            indicator = f32(max(0.0, float(np.sign(threshold - count))))
            v = v * indicator + (f32(1.0) - indicator) * f32(scale) * v
        return v

    if warmup_steps <= 0:
        return lambda count: float(piecewise(count))
    lo = base * 0.02

    def warm(count: int):
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1.0) - c / f32(warmup_steps)
        return f32(lo - base) * frac + f32(base)

    return lambda count: float(warm(count) if count < warmup_steps
                               else piecewise(count - warmup_steps))


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / their global norm where
    that norm is >= max_norm (``optax.clip_by_global_norm``; no epsilon, no
    host wait).  Returns the norm (a device scalar)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """``make_optimizer``'s chain over a module's parameters."""

    def __init__(self, model: nn.Module, cfg: dict, steps_per_epoch: int):
        self.kind = cfg.get("optimizer_type", "adam")
        self.schedule = multistep_lr(cfg.get("start_lr", 0.01), cfg.get("batch_size", 32),
                                     cfg.get("lr_milestones", []), steps_per_epoch,
                                     warmup_steps=cfg.get("warmup_steps", 0))
        self.max_norm = float(cfg.get("grad_clip_norm", 1.0))
        self.named = list(model.named_parameters())
        params = [p for _, p in self.named]
        if self.kind == "adam":
            self.opt = torch.optim.Adam(params, lr=self.schedule(0), betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=cfg.get("weight_decay", 0.0))
        else:
            self.opt = torch.optim.SGD(params, lr=self.schedule(0), momentum=0.9)
        self.count = 0  # the schedule's step count

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        clip_by_global_norm_([p.grad for _, p in self.named], self.max_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    # ---- the state as optax's, and back ---------------------------------

    def _buffers(self, key: str) -> dict:
        return {n: self.opt.state.get(p, {}).get(key, torch.zeros_like(p))
                for n, p in self.named}

    def state_tree(self) -> dict:
        """The state as flax serializes optax's chain state."""
        sched = {"count": np.asarray(self.count, np.int32)}
        if self.kind == "adam":
            first = self.opt.state.get(self.named[0][1], {})
            count = int(first["step"]) if "step" in first else 0
            adam = {"count": np.asarray(count, np.int32),
                    "mu": convert.flax_params(self._buffers("exp_avg")),
                    "nu": convert.flax_params(self._buffers("exp_avg_sq"))}
            return {"0": {}, "1": {}, "2": {"0": adam, "1": sched}}
        return {"0": {}, "1": {"0": {"trace": convert.flax_params(
            self._buffers("momentum_buffer"))}, "1": sched}}

    def load_state_tree(self, tree: dict) -> None:
        """Set the state from optax's (``state_tree``'s inverse)."""
        if self.kind == "adam":
            adam, sched = tree["2"]["0"], tree["2"]["1"]
            moments = {"exp_avg": convert.flax_state_dict(adam["mu"]),
                       "exp_avg_sq": convert.flax_state_dict(adam["nu"])}
            step = float(adam["count"])
        else:
            sched = tree["1"]["1"]
            moments = {"momentum_buffer": convert.flax_state_dict(tree["1"]["0"]["trace"])}
        for n, p in self.named:
            st = self.opt.state[p]
            for key, values in moments.items():
                st[key] = values[n].to(device=p.device, dtype=p.dtype).contiguous()
            if self.kind == "adam":
                st["step"] = torch.tensor(step, dtype=torch.float32)
        self.count = int(sched["count"])


def make_optimizer(model: nn.Module, cfg: dict, steps_per_epoch: int) -> Optimizer:
    return Optimizer(model, cfg, steps_per_epoch)


@dataclass
class TrainState:
    """The module (its parameters are the train state's), its optimizer
    and the step count."""

    model: nn.Module
    tx: Optimizer
    step: int = 0


def create_state(model: nn.Module, cfg: dict, steps_per_epoch: int = 100,
                 device=None) -> TrainState:
    """Initialise ``model`` as flax would (``nn.init.init_like_flax``, drawn
    on the host from ``cfg["random_seed"]``), move it to ``device`` and give
    it a fresh optimizer."""
    init_like_flax(model, torch.Generator().manual_seed(int(cfg.get("random_seed", 0))))
    if device is not None:
        model.to(device)
    return TrainState(model=model, tx=make_optimizer(model, cfg, steps_per_epoch))


class ShardedModule(nn.Module):
    """``model`` data-parallel over a mesh's batch shards: each call splits
    every tensor argument on dim 0 over ``dp_sharding(mesh)``, runs the
    model on each shard's device with its parameters copied there
    (``torch.func.functional_call``), and returns the outputs (a tensor or
    a tuple of them) concatenated in order on the model's device.
    The copies are differentiable, so one ``backward()`` of a loss on the
    gathered outputs sums every shard's gradient into the model's own
    parameters: the all-reduce that XLA inserts for JAX's sharded step."""

    def __init__(self, model: nn.Module, mesh):
        super().__init__()
        self.model = model
        self.mesh = mesh

    def forward(self, *args, **kwargs):
        home = model_device(self.model)
        devs = dp_sharding(self.mesh)
        named = list(self.model.named_parameters())
        on = {d: {k: p.to(d) for k, p in named} for d in dict.fromkeys(devs)}
        outs = [tree_map(lambda t: t.to(home),
                         torch.func.functional_call(self.model, on[d], *to_device(shard, d)))
                for d, shard in zip(devs, split((args, kwargs), len(devs)))]
        return tree_map(lambda *xs: torch.cat(xs), *outs)


def make_train_step(loss_fn: Callable, mesh=None):
    """``step(state, batch) -> (state, loss, aux)``: the loss and its
    gradients at the current parameters, then one optimizer step.
    ``loss_fn(model, batch, train) -> (loss, aux)``.  With a mesh, the loss
    sees the model as a ``ShardedModule``: the forward runs data-parallel
    over the mesh's batch shards and the loss is taken on the gathered
    outputs, so the step equals the one-device step on the whole batch for
    any normalisation of the loss.  The parameters, the optimizer and its
    state stay on the model's device, and checkpoints keep their format.
    A net that draws dropout masks draws one per shard (on the one device,
    one for the batch): the two steps then agree in distribution only."""

    def step(state: TrainState, batch: dict):
        model = state.model if mesh is None else ShardedModule(state.model, mesh)
        loss, aux = loss_fn(model, batch, True)
        state.tx.zero_grad()
        loss.backward()
        state.tx.step()
        state.step += 1
        return state, loss.detach(), aux

    return step


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@dataclass
class Trainer:
    """The epoch loop shared by the three nets (the reference's
    ``trainer_grasp.py:44-115``)."""

    model: Any
    cfg: dict
    loss_fn: Callable
    train_data: Callable  # () -> iterator of batches (host numpy dicts)
    val_data: Callable | None = None
    mesh: Any = None  # parallel.mesh.Mesh: the train step data-parallel over its batch shards
    ckpt_dir: str = "artifacts_torch"
    best_train: float = field(default=float("inf"))
    best_val: float = field(default=float("inf"))

    def __post_init__(self):
        refuse_tracked(self.ckpt_dir)

    def fit(self, state: TrainState, n_epochs: int | None = None, log_every: int = 50,
            verbose: bool = True, max_seconds: float | None = None,
            start_epoch: int = 0) -> TrainState:
        """Train ``n_epochs`` (default ``cfg["n_epochs"]``) from
        ``start_epoch``; a resumed run trains at least one epoch.
        ``max_seconds`` bounds the wall clock, checked at each log interval
        (where ``last.ckpt`` is then saved too) and at each epoch's end; the
        partial epoch is scored and checkpointed like a full one.  With
        ``plateau_patience`` > 0, that many epochs without a val improvement
        revert to the best_val parameters and restart the optimizer at
        start_lr x plateau_gamma^k (its schedule over
        ``cfg["steps_per_epoch"]``, default 100, as the JAX trainer does).
        Losses stay on the device between log intervals.  Each batch's
        fetch (``input.next``), copy (``input.to_device``) and enqueue
        (``train.step``), the evaluations and the checkpoints are spans of
        ``utils/profiling.py``; their totals over the call are its
        ``timing`` event in ``metrics.jsonl`` and ``profiling.last_fit()``."""
        n_epochs = n_epochs or self.cfg.get("n_epochs", 1)
        n_epochs = max(n_epochs, start_epoch + 1)
        if max_seconds is None:
            max_seconds = self.cfg.get("max_seconds")
        plateau_patience = int(self.cfg.get("plateau_patience", 0))
        plateau_gamma = float(self.cfg.get("plateau_gamma", 0.3))
        lr_scale, since_best = 1.0, 0
        steps_per_epoch = max(int(self.cfg.get("steps_per_epoch", 100)), 1)
        t_start = time.monotonic()
        step_fn = make_train_step(self.loss_fn, self.mesh)
        dev = model_device(state.model)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        mlog = MetricsLogger(f"{self.ckpt_dir}/metrics.jsonl", run=type(self.model).__name__)
        spans = profiling.begin_fit()
        expired = False
        for epoch in range(start_epoch, n_epochs):
            loss_sum, loss_n, window = 0.0, 0, []

            def drain():
                nonlocal loss_sum, loss_n
                if window:
                    loss_sum += float(torch.stack(window).sum())
                    loss_n += len(window)
                    window.clear()

            with profiling.trace():  # CATGRASP_TRACE_DIR gates capture
                batches = iter(self.train_data())
                for i in itertools.count():
                    with profiling.span("input.next"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    with profiling.span("input.to_device", device_work=True):
                        batch = to_device(batch, dev)
                    with profiling.span("train.step", device_work=True):  # the enqueue
                        state, loss, _ = step_fn(state, batch)
                    window.append(loss)  # on the device until the drain
                    if i % log_every == log_every - 1:
                        if verbose:
                            print(f"epoch {epoch} it {i} loss {float(loss):.4f}", flush=True)
                        drain()
                        if max_seconds is not None:
                            save_checkpoint(f"{self.ckpt_dir}/last.ckpt", state, epoch)
                            if time.monotonic() - t_start > max_seconds:
                                expired = True
                                break
            drain()
            save_checkpoint(f"{self.ckpt_dir}/last.ckpt", state, epoch)
            if (max_seconds is not None and not expired
                    and time.monotonic() - t_start > max_seconds):
                expired = True
            train_loss = loss_sum / loss_n if loss_n else float("inf")
            rec = {"epoch": epoch, "train_loss": train_loss}
            if train_loss < self.best_train:
                self.best_train = train_loss
                save_checkpoint(f"{self.ckpt_dir}/best_train.ckpt", state, epoch)
            if self.val_data is not None:
                val_loss = self.evaluate(state)
                rec["val_loss"] = val_loss
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    since_best = 0
                    save_checkpoint(f"{self.ckpt_dir}/best_val.ckpt", state, epoch)
                else:
                    since_best += 1
                    if plateau_patience and since_best >= plateau_patience:
                        lr_scale *= plateau_gamma
                        since_best = 0
                        cfg2 = dict(self.cfg)
                        cfg2["start_lr"] = self.cfg.get("start_lr", 0.01) * lr_scale
                        best_path = f"{self.ckpt_dir}/best_val.ckpt"
                        if os.path.exists(best_path):
                            load_params(best_path, state.model)
                        state = TrainState(model=state.model,
                                           tx=make_optimizer(state.model, cfg2, steps_per_epoch))
                        rec["plateau_restart_lr_scale"] = lr_scale
                        if verbose:
                            print(f"epoch {epoch}: val plateau — reverting to best_val, "
                                  f"lr x{lr_scale:.3g}", flush=True)
                if verbose:
                    print(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f}")
            mlog.event("epoch", **rec)
            if expired:
                if verbose:
                    print(f"wall-clock bound {max_seconds}s reached at epoch {epoch}; stopping",
                          flush=True)
                break
        mlog.event("timing", **profiling.end_fit(spans))
        mlog.close()
        return state

    def evaluate(self, state: TrainState) -> float:
        """The mean training loss over the val batches, without gradients,
        as JAX's ``evaluate`` takes it: the loss in training mode, so the
        grasp net's dropout is on, with every batch's draws made from seed
        0 (JAX's ``PRNGKey(0)``: the same mask for every batch of a shape,
        and the training stream left where it was)."""
        dev = model_device(state.model)
        losses = []
        with profiling.span("train.evaluate", device_work=True), torch.no_grad():
            for batch in self.val_data():
                with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
                    torch.manual_seed(0)
                    losses.append(self.loss_fn(state.model, to_device(batch, dev), True)[0])
            return float(torch.stack(losses).mean()) if losses else float("inf")


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def save_checkpoint(path: str, state: TrainState, epoch: int) -> None:
    """The JAX trainer's checkpoint: a msgpack map of the flax parameter
    blob, the optax state blob, the step and the epoch (no pickle)."""
    with profiling.span("ckpt.save", device_work=True):
        blob = {"params": ckpt.packb(convert.flax_params(state.model.state_dict())),
                "opt_state": ckpt.packb(state.tx.state_tree()),
                "step": int(state.step), "epoch": int(epoch)}
        ckpt.write_checkpoint_blob(path, blob)


read_checkpoint_blob = ckpt.read_checkpoint_blob


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Copy a checkpoint's parameters (a training checkpoint or a
    params-only export) into ``model``."""
    sd = convert.flax_state_dict(ckpt.unpackb(read_checkpoint_blob(path)["params"]))
    model.load_state_dict(sd)
    return model


def load_checkpoint(path: str, state: TrainState) -> tuple[TrainState, int]:
    """Resume: parameters, optimizer state and step from a training
    checkpoint of either package; returns (state, its epoch)."""
    blob = read_checkpoint_blob(path)
    if "opt_state" not in blob:
        raise ValueError(
            f"{path} is a params-only eval checkpoint (no opt_state) — it "
            "cannot seed --resume; resume from a last.ckpt or load it for "
            "inference via load_params")
    state.model.load_state_dict(convert.flax_state_dict(ckpt.unpackb(blob["params"])))
    state.tx.load_state_tree(ckpt.unpackb(blob["opt_state"]))
    state.step = int(blob["step"])
    return state, int(blob["epoch"])


def warm_start_params(path: str, state: TrainState) -> TrainState:
    """Seed only the parameters from a checkpoint (a training checkpoint or
    a params-only export such as ``artifacts_tracked/``), keeping the fresh
    optimizer."""
    load_params(path, state.model)
    return state


def start_state(state: TrainState, resume: str | None = None,
                init_params: str | None = None) -> tuple[TrainState, int]:
    """The trainers' ``--resume`` (a training checkpoint: the run continues
    at its next epoch) or ``--init_params`` (parameters only, a fresh
    optimizer); returns (state, the first epoch)."""
    if resume:
        state, ep = load_checkpoint(resume, state)
        print(f"resumed from {resume} (epoch {ep})")
        return state, ep + 1
    if init_params:
        state = warm_start_params(init_params, state)
        print(f"warm-started params from {init_params}")
    return state, 0


def add_common_args(ap, net: str) -> None:
    """The trainers' shared command-line options."""
    ap.add_argument("--class_name", default="nut")
    ap.add_argument("--data_root", default=None,
                    help="packed rows (pack_training_data) or scene files; default the "
                         "class's packed train split, else its scenes")
    ap.add_argument("--val_root", default=None,
                    help="packed val split for per-epoch val loss / best_val")
    ap.add_argument("--n_epochs", type=int, default=None)
    ap.add_argument("--ckpt_dir", default=f"{DEFAULT_CKPT_ROOT}/{net}")
    ap.add_argument("--resume", default=None, help="training checkpoint to resume from")
    ap.add_argument("--init_params", default=None,
                    help="params-only warm start (e.g. artifacts_tracked/<class>/"
                         f"{net}/best_val.ckpt); fresh optimizer")
    ap.add_argument("--max_seconds", type=float, default=None,
                    help="wall-clock bound; the partial epoch is checkpointed")
    ap.add_argument("--device", default=None)


def default_data_root(class_name: str) -> str:
    from ..data import packed
    from ..pipelines.generate_pile_data import default_out_dir
    from ..pipelines.pack_training_data import default_packed_dir
    root = default_packed_dir(class_name, "train")
    return root if packed.is_packed(root) else default_out_dir(class_name, "train")
