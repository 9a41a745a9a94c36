"""Score a set of nut nets offline on a packed val split, with the port
only: the seg and NUNOCS nets' val losses as their trainers take them
(``Trainer.evaluate``: the mean training loss over the val batches, seed 0
for each batch's draws), the grasp net as ``scripts/graspnet_diag.py``
scores it (4,096 held-out grasps drawn by ``default_rng(0)``, the raw and
the ``prior.json``-corrected CE, Spearman(expected bin, score), the
exact-bin and within-one-bin accuracy), and with ``--init`` each net's
relative L2 change of its parameters from another set.

    python scripts/train_offline_score.py --artifacts artifacts_torch/nut_warm \\
        --val_root dataset/torch/nut/packed_val --init artifacts_tracked/nut \\
        --out chiprun_out/train_loop/offline.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.data import packed
from catgrasp_tpu_torch.device import resolve_device
from catgrasp_tpu_torch.pipelines.rescore_grasp_db import spearman_np
from catgrasp_tpu_torch.predict.artifacts import _ckpt
from catgrasp_tpu_torch.predict.ckpt import read_params
from catgrasp_tpu_torch.train import trainer as T

NET_DIRS = ("seg", "nunocs", "grasp")


def val_loss(net: str, art: str, val_root: str, dev) -> float:
    """The net's val loss on the split, as its trainer's ``evaluate`` takes
    it at the trainer's batch (seg 4, NUNOCS 34)."""
    from scripts.train_parity_protocol import port_net

    cfg, model, loss_fn, data = port_net(net)
    cfg["batch_size"] = {"seg": 4}.get(net, load_config(f"config_{net}.yml")["batch_size"])
    T.load_params(_ckpt(os.path.join(art, net)), model)
    model.to(dev)
    val = data(val_root, cfg) if net == "seg" else data(val_root, cfg, phase="val")
    tr = T.Trainer(model=model, cfg=cfg, loss_fn=loss_fn,
                   train_data=lambda: iter(()),
                   val_data=lambda: val.batches(cfg["batch_size"], shuffle=False))
    return tr.evaluate(T.TrainState(model=model, tx=None))


def grasp_diag(art: str, val_root: str, dev, n: int = 4096) -> dict:
    """``scripts/graspnet_diag.py``'s metrics of ``art``'s grasp net."""
    from catgrasp_tpu_torch.predict.artifacts import load_predicters

    pred = load_predicters(art, "nut", device=dev, roles=("grasp",))["grasp"]
    cfg = load_config("config_grasp.yml")
    ds = packed.PackedGrasp(val_root, cfg, phase="val")
    rng = np.random.default_rng(0)
    ks = rng.choice(len(ds), min(n, len(ds)), replace=False)
    n_pts = cfg.get("n_pts", 2048)
    probs, labels, scores = [], [], []
    for i in range(0, len(ks), 256):
        kk = ks[i:i + 256]
        raw = ds.clouds[ds.cloud_row[kk]]
        idx = rng.integers(0, ds.P, (len(kk), n_pts))
        raw = np.take_along_axis(raw, idx[..., None], axis=1).astype(np.float32)
        tf = np.linalg.inv(ds.pose[kk])
        xyz = np.einsum("bij,bpj->bpi", tf[:, :3, :3], raw[..., :3]) + tf[:, None, :3, 3]
        nrm = np.einsum("bij,bpj->bpi", tf[:, :3, :3], raw[..., 3:6])
        x = torch.as_tensor(np.concatenate([xyz, nrm], -1), dtype=torch.float32, device=dev)
        with torch.inference_mode():
            probs.append(torch.softmax(pred.model(x)[0], -1).cpu().numpy())
        labels.append(np.digitize(ds.score[kk], ds.classes) - 1)
        scores.append(ds.score[kk])
    probs, labels, scores = (np.concatenate(v) for v in (probs, labels, scores))
    nb = probs.shape[1]
    rows = np.arange(len(labels))
    ce_raw = float(-np.log(np.maximum(probs[rows, labels], 1e-9)).mean())
    prior_path = os.path.join(art, "grasp", "prior.json")
    corrected = os.path.exists(prior_path)
    if corrected:
        with open(prior_path) as f:
            prior = np.asarray(json.load(f)["bin_prior"], np.float64)
        probs = probs * prior[None, :]
        probs = probs / probs.sum(-1, keepdims=True)
    expq = (probs * (np.arange(nb) + 0.5) / nb).sum(-1)
    marg = np.bincount(labels, minlength=nb) / len(labels)
    return {"n": int(len(labels)), "val_ce_raw": ce_raw,
            "val_ce": float(-np.log(np.maximum(probs[rows, labels], 1e-9)).mean()),
            "prior_corrected": corrected, "spearman": spearman_np(expq, scores),
            "acc": float((probs.argmax(-1) == labels).mean()),
            "within1": float((np.abs(probs.argmax(-1) - labels) <= 1).mean()),
            "marginal_entropy": float(-(marg[marg > 0] * np.log(marg[marg > 0])).sum())}


def param_change(art: str, init: str) -> dict:
    """Each net's ||params - init|| / ||init||."""
    from scripts.train_parity_protocol import flat, rel_l2

    return {net: rel_l2(*(flat(read_params(_ckpt(os.path.join(d, net)))) for d in (art, init)))
            for net in NET_DIRS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", required=True, help="the directory holding seg/nunocs/grasp")
    ap.add_argument("--val_root", default="dataset/torch/nut/packed_val")
    ap.add_argument("--init", default=None, help="a set to measure the parameters' change from")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    row = {"artifacts": args.artifacts, "val_root": args.val_root,
           "seg_val_loss": val_loss("seg", args.artifacts, args.val_root, dev),
           "nunocs_val_loss": val_loss("nunocs", args.artifacts, args.val_root, dev),
           "grasp": grasp_diag(args.artifacts, args.val_root, dev)}
    calib = os.path.join(args.artifacts, "seg", "calib.json")
    if os.path.exists(calib):
        with open(calib) as f:
            row["seg_bandwidth"] = json.load(f)["bandwidth"]
    if args.init:
        row["param_rel_change"] = param_change(args.artifacts, args.init)
    print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


if __name__ == "__main__":
    main()
