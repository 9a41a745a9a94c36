"""Train the grasp-quality classifier (``catgrasp_tpu/pipelines/
train_grasp.py`` in PyTorch): ``PointNetCls`` (10 score bins, dropout 0.4)
under CE + the ordinal auxiliary + 1e-3 x the feature-transform
regularizer, ``config_grasp.yml``'s schedule (warmup, milestones, the
val-plateau restart), on one GPU.  Writes ``prior.json`` beside the
checkpoints: the train split's score-bin prior (+1 smoothing), which
inference applies to a net trained on bin-balanced draws.

    python -m catgrasp_tpu_torch.pipelines.train_grasp --class_name nut \\
        --data_root dataset/torch/nut/packed_train --n_epochs 1
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config.loader import load_config
from ..data import packed
from ..data.datasets import GraspDataset
from ..device import resolve_device
from ..nn.losses import grasp_quality_ce, grasp_quality_ordinal
from ..nn.pointnet import PointNetCls, feature_transform_regularizer
from ..train import trainer as T


def build(cfg: dict):
    """(model, loss_fn(model, batch, train) -> (loss, {"acc"}))."""
    model = PointNetCls(len(cfg["classes"]) - 1, cfg.get("input_channel", 6))
    w_ord = cfg.get("ordinal_weight", 1.0)

    def loss_fn(model, batch, train):
        logits, trans_feat = model(batch["x"], train=train)
        label = batch["label"].long()
        loss = grasp_quality_ce(logits, label) + w_ord * grasp_quality_ordinal(logits, label)
        loss = loss + 1e-3 * feature_transform_regularizer(trans_feat)
        acc = torch.mean((torch.argmax(logits, -1) == label).float())
        return loss, {"acc": acc}

    return model, loss_fn


def bin_prior(scores, classes) -> dict:
    """``prior.json``: the natural score-bin marginal of the train split,
    with +1 smoothing."""
    classes = np.asarray(classes, np.float32)
    bins = np.digitize(np.asarray(scores, np.float32), classes) - 1
    prior = np.bincount(bins, minlength=len(classes) - 1) + 1.0
    return {"bin_prior": (prior / prior.sum()).tolist(), "n": int(len(bins))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    T.add_common_args(ap, "grasp")
    ap.add_argument("--grasp_db", default=None, help="grasp DB npz (unpacked path only)")
    ap.add_argument("--batch_size", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config("config_grasp.yml")
    if args.batch_size:
        cfg["batch_size"] = args.batch_size
    root = args.data_root or T.default_data_root(args.class_name)
    if packed.is_packed(root):
        ds = packed.PackedGrasp(root, cfg)
    else:
        ds = GraspDataset(root, dict(np.load(args.grasp_db)), cfg)
    val = (packed.PackedGrasp(args.val_root, cfg, phase="val")
           if args.val_root and packed.is_packed(args.val_root) else None)
    print(f"train items: {len(ds)}" + (f", val items: {len(val)}" if val else ""))

    scores = ds.score if hasattr(ds, "score") else [k[2] for k in ds.keys]
    prior = bin_prior(scores, cfg["classes"])
    prior["balanced_training"] = bool(cfg.get("balance_bins", True))
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(os.path.join(args.ckpt_dir, "prior.json"), "w") as f:
        json.dump(prior, f)

    model, loss_fn = build(cfg)
    bs = cfg["batch_size"]
    state = T.create_state(model, cfg, max(len(ds) // bs, 1), device=dev)
    state, start_epoch = T.start_state(state, args.resume, args.init_params)
    trainer = T.Trainer(model=model, cfg=cfg, loss_fn=loss_fn,
                        train_data=lambda: ds.batches(bs),
                        val_data=(lambda: val.batches(bs, shuffle=False)) if val else None,
                        ckpt_dir=args.ckpt_dir)
    return trainer.fit(state, n_epochs=args.n_epochs, max_seconds=args.max_seconds,
                       start_epoch=start_epoch)


if __name__ == "__main__":
    main()
