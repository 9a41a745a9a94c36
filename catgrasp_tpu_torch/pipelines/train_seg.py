"""Train the instance-segmentation net (``catgrasp_tpu/pipelines/
train_seg.py`` in PyTorch): ``SegNet`` under the offset loss plus a
class-balanced objectness BCE, each scene with its own grid origin (its
cloud's minimum less 1 cm).  The batch's scenes are voxelized together with
a scene index (JAX ``vmap``s the one-scene net); each scene's loss is its
own, and the batch's is their mean.

    python -m catgrasp_tpu_torch.pipelines.train_seg --class_name nut \\
        --data_root dataset/torch/nut/packed_train --n_epochs 1
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..config.loader import load_config
from ..data import packed
from ..data.datasets import SegDataset
from ..device import resolve_device
from ..nn.losses import offset_loss
from ..nn.voxelnet import SegNet
from ..train import trainer as T


def build(cfg: dict):
    """(model, loss_fn(model, batch, train) -> (loss, aux))."""
    model = SegNet(voxel_size=float(cfg.get("voxel_size", 0.004)),
                   grid_dims=tuple(cfg.get("grid_dims", (96, 96, 48))))

    def loss_fn(model, batch, train):
        xyz, inst = batch["xyz"], batch["instance_id"]
        origin = torch.amin(xyz, dim=1) - 0.01  # (B, 3)
        offsets, objness = model(xyz, batch["normal"], origin)
        is_obj = inst >= 0
        l_off = offset_loss(offsets, batch["offsets"], is_obj)  # (B,)
        # class-balanced BCE: object points are a few % of a scene cloud
        y = is_obj.float()
        pos = torch.clamp(y.sum(dim=-1), min=1.0)
        neg = torch.clamp((1 - y).sum(dim=-1), min=1.0)
        bce = F.binary_cross_entropy_with_logits(objness, y, reduction="none")
        w = torch.where(is_obj, (neg / pos)[:, None], 1.0)
        l_obj = torch.sum(bce * w, dim=-1) / torch.sum(w, dim=-1)
        return torch.mean(l_off + l_obj), {}

    return model, loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    T.add_common_args(ap, "seg")
    ap.add_argument("--batch_size", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config("config_seg.yml")
    cfg["batch_size"] = args.batch_size
    root = args.data_root or T.default_data_root(args.class_name)
    ds = packed.PackedSeg(root, cfg) if packed.is_packed(root) else SegDataset(root, cfg)
    val = (packed.PackedSeg(args.val_root, cfg)
           if args.val_root and packed.is_packed(args.val_root) else None)
    print(f"train scenes: {len(ds)}" + (f", val: {len(val)}" if val else ""))

    model, loss_fn = build(cfg)
    bs = args.batch_size
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
