"""The plain reference of a training cell's steps: the net, its loss, the
gradient clip, Adam with its L2 decay and the learning-rate schedule,
written out in plain PyTorch, on the batches worked out again from the
packed split.  It follows the set-up's first steps from the weights the
benchmark made, and the window's first steps from the program's state at
the window's start.

The grasp net's dropout draws from torch's generator on the device; the
reference seeds it as the benchmark seeded it before the set-up's first
step and before the window's, and draws the same masks by the same calls
(``F.dropout`` at the same shapes, in the same order).

``fault`` plants one of the faults the limits were read against, in the
reference put in the program's place: ``"half"`` takes the loss over the
first half of each batch, ``"label"`` alters the first sample's label,
``"unchanged"`` leaves the state as it was at each step."""
from __future__ import annotations

import numpy as np
import torch

from .nets import losses, packed, pointnet, symmetry

BETAS = (0.9, 0.999)
EPS = 1e-8


def lr_schedule(cfg: dict, steps_per_epoch: int):
    """The learning rate at a step count: base = start_lr / 64 x batch,
    x0.1 from each milestone epoch, after a linear warmup from 0.02 base;
    in float32 (a frozen copy of the port's ``train/trainer.py:multistep_lr``)."""
    f32 = np.float32
    base = cfg.get("start_lr", 0.01) / 64.0 * cfg.get("batch_size", 32)
    bounds = sorted({m * steps_per_epoch: 0.1 for m in cfg.get("lr_milestones", [])}.items())
    warmup = cfg.get("warmup_steps", 0)

    def piecewise(count):
        v = f32(base)
        for threshold, scale in bounds:
            indicator = f32(max(0.0, float(np.sign(threshold - count))))
            v = v * indicator + (f32(1.0) - indicator) * f32(scale) * v
        return v

    def lr(count):
        if count >= warmup:
            return float(piecewise(count - warmup))
        frac = f32(1.0) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(f32(base * 0.02 - base) * frac + f32(base))

    return lr


def build(net: str, cfg: dict, class_name: str, device):
    """``loss(params, batch) -> scalar`` of ``net`` in training mode, as the
    training pipelines configure it."""
    if net == "grasp":
        w_ord = cfg.get("ordinal_weight", 1.0)

        def loss(params, batch):
            logits, trans_feat = pointnet.classifier(params, batch["x"], train=True)
            return losses.grasp_loss(logits, batch["label"].long(), trans_feat, w_ord)
    elif net == "nunocs":
        bins = cfg.get("ce_loss_bins", 100)
        sym = torch.as_tensor(symmetry.get_symmetry_tfs(class_name), dtype=torch.float32,
                              device=device)

        def loss(params, batch):
            return losses.nocs_loss(pointnet.segmenter(params, batch["x"]), batch["nocs"], sym, bins)
    else:
        raise ValueError(f"unknown net {net!r}")
    return loss


def dataset(net: str, split_dir: str, cfg: dict):
    return (packed.PackedGrasp if net == "grasp" else packed.PackedNunocs)(split_dir, cfg)


def _planted(batch: dict, fault: str | None) -> dict:
    if fault == "half":
        return {k: v[: len(v) // 2] for k, v in batch.items()}
    if fault == "label":
        batch = dict(batch)
        if "label" in batch:
            batch["label"] = batch["label"].clone()
            batch["label"][0] = (batch["label"][0] + 5) % 10
        else:
            batch["nocs"] = batch["nocs"].clone()
            batch["nocs"][0] = 1.0 - batch["nocs"][0]
        return batch
    if fault not in (None, "unchanged"):
        raise ValueError(f"unknown fault {fault!r}")
    return batch


def steps(net: str, cfg: dict, class_name: str, split_dir: str, params: dict, n_steps: int,
          seed: int, device, fault: str | None = None, state: dict | None = None,
          after: int = 0) -> dict:
    """``n_steps`` training steps from ``params`` (tensors by leaf name),
    torch's generator seeded with ``seed`` first (the dropout masks' stream).

    Without ``state`` they are the first steps from the weights, on the
    first batches of a pass over the split.  With ``state`` (the optimizer's
    moments ``exp_avg`` and ``exp_avg_sq`` by leaf name, and ``count``, the
    steps it has taken) they continue from it: the first ``after`` batches
    of one pass are drawn and dropped, and the steps take a new pass's.

    Returns ``losses`` (floats), ``first_grad`` (each leaf's gradient as the
    optimizer took it at the first step: clipped, plus the L2 decay) and
    ``params`` after the steps, on the host."""
    dev = torch.device(device)
    loss_fn = build(net, cfg, class_name, dev)
    params = {name: w.detach().to(dev, copy=True).requires_grad_(True)
              for name, w in params.items()}
    ds = dataset(net, split_dir, cfg)
    bs = cfg["batch_size"]
    lr = lr_schedule(cfg, max(len(ds) // bs, 1))
    wd, max_norm = cfg.get("weight_decay", 0.0), float(cfg.get("grad_clip_norm", 1.0))
    if state is None:
        m = {name: torch.zeros_like(p) for name, p in params.items()}
        v = {name: torch.zeros_like(p) for name, p in params.items()}
        k = 0
    else:
        m = {name: state["exp_avg"][name].to(dev, copy=True) for name in params}
        v = {name: state["exp_avg_sq"][name].to(dev, copy=True) for name in params}
        k = state["count"]
    feed = ds.batches(bs)
    if after:
        for _ in range(after):
            next(feed)
        feed.close()
        feed = ds.batches(bs)
    out = {"losses": []}
    torch.manual_seed(seed)
    for i in range(n_steps):
        batch = {key: torch.from_numpy(val).to(dev) for key, val in next(feed).items()}
        loss = loss_fn(params, _planted(batch, fault))
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        out["losses"].append(float(loss.detach()))
        if fault == "unchanged":  # the step leaves the state, Adam's moments too, as it was
            if i == 0:
                out["first_grad"] = {name: torch.zeros_like(p, device="cpu")
                                     for name, p in params.items()}
            continue
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params.values())]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
            t = k + 1
            step_size = lr(k) / (1 - BETAS[0] ** t)
            root_bc2 = (1 - BETAS[1] ** t) ** 0.5
            for (name, p), g in zip(params.items(), grads):
                g = g * scale + wd * p
                if i == 0:
                    out.setdefault("first_grad", {})[name] = g.cpu()
                m[name] = BETAS[0] * m[name] + (1 - BETAS[0]) * g
                v[name] = BETAS[1] * v[name] + (1 - BETAS[1]) * g * g
                p -= step_size * m[name] / (torch.sqrt(v[name]) / root_bc2 + EPS)
        k += 1
    feed.close()
    out["params"] = {name: p.detach().to("cpu", copy=True) for name, p in params.items()}
    return out
