"""Train the NUNOCS coordinate net (``catgrasp_tpu/pipelines/train_nunocs.py``
in PyTorch): ``PointNetSeg`` with 3 x 100 bins under the min-over-symmetries
cross-entropy, ``config_nunocs.yml``'s schedule (Adam, lr = 0.01 / 64 x
batch, MultiStepLR), on one GPU.

    python -m catgrasp_tpu_torch.pipelines.train_nunocs --class_name nut \\
        --data_root dataset/torch/nut/packed_train --n_epochs 1
"""
from __future__ import annotations

import argparse

import torch

from ..config.loader import load_config
from ..core.symmetry import get_symmetry_tfs
from ..data import packed
from ..data.datasets import NunocsDataset
from ..device import resolve_device
from ..nn.losses import nocs_min_symmetry_ce
from ..nn.pointnet import PointNetSeg
from ..train import trainer as T


def build(cfg: dict, class_name: str):
    """(model, loss_fn(model, batch, train) -> (loss, aux))."""
    bins = cfg.get("ce_loss_bins", 100)
    model = PointNetSeg(3 * bins, cfg.get("input_channel", 6))
    sym_np = get_symmetry_tfs(class_name)
    sym = {}  # the symmetry table on each device, copied there once

    def loss_fn(model, batch, train):
        dev = batch["x"].device
        if dev not in sym:
            sym[dev] = torch.as_tensor(sym_np, dtype=torch.float32, device=dev)
        logits, _ = model(batch["x"], train=train)
        return nocs_min_symmetry_ce(logits, batch["nocs"], sym[dev], bins), {}

    return model, loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    T.add_common_args(ap, "nunocs")
    ap.add_argument("--batch_size", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config("config_nunocs.yml")
    if args.batch_size:
        cfg["batch_size"] = args.batch_size
    root = args.data_root or T.default_data_root(args.class_name)
    ds = (packed.PackedNunocs(root, cfg) if packed.is_packed(root)
          else NunocsDataset(root, cfg))
    val = None
    if args.val_root:
        val = (packed.PackedNunocs(args.val_root, cfg, phase="val")
               if packed.is_packed(args.val_root)
               else NunocsDataset(args.val_root, cfg, phase="val"))
    print(f"train items: {len(ds)}" + (f", val items: {len(val)}" if val else ""))

    model, loss_fn = build(cfg, args.class_name)
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
