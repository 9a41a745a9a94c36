"""The training batches, worked out again from a packed split: a frozen
copy of the port's ``data/packed.py`` readers (``PackedNunocs`` and
``PackedGrasp``: the memmapped rows, the resample, dropout, normalisation
and flip, the bin-balanced draws), for the benchmark's plain reference.

Layout under a split's directory: ``meta.json`` (counts and row shapes),
``nunocs.bin`` (M, P0, 9) f16 [xyz | normal | nocs], ``grasp_cloud.bin``
(Sg, P2, 6) f16 scene clouds, ``grasp_keys.npz`` (pose (K, 4, 4) f32,
score (K,), cloud_row (K,))."""
from __future__ import annotations

import json
import os

import numpy as np

META = "meta.json"


def _load_meta(out_dir: str) -> dict:
    with open(os.path.join(out_dir, META)) as f:
        return json.load(f)


def _batch_indices(rng, n_src, n_out, B, dropout_prob, dropout_max_ratio):
    """Per-item resample (+ optional dropout) index matrix (B, n_out) —
    the vectorized equivalent of augment.resample + augment.dropout_cloud."""
    idx = np.empty((B, n_out), np.int64)
    for b in range(B):
        if dropout_prob > 0 and rng.random() <= dropout_prob:
            keep = max(int(n_src * (1 - rng.uniform(0, dropout_max_ratio))), 8)
            pool = rng.choice(n_src, keep, replace=False)
            idx[b] = pool[rng.integers(0, keep, n_out)]
        else:
            idx[b] = rng.choice(n_src, n_out, replace=n_src < n_out)
    return idx


class PackedNunocs:
    """Memmap-backed NUNOCS dataset with `datasets.NunocsDataset` batch
    semantics."""

    def __init__(self, out_dir: str, cfg: dict, phase: str = "train", seed: int = 0):
        self.cfg, self.phase = cfg, phase
        self.rng = np.random.default_rng(seed)
        m = _load_meta(out_dir)
        self.P = m["nunocs_pts"]
        self.arr = np.memmap(os.path.join(out_dir, "nunocs.bin"), np.float16,
                             "r", shape=(m["n_nunocs"], self.P, 9))

    def __len__(self):
        return self.arr.shape[0]

    def batches(self, batch_size: int, shuffle: bool = True):
        n_pts = self.cfg.get("n_pts", 1024)
        dp = self.cfg.get("dropout_prob", 0.5) if self.phase == "train" else 0.0
        dr = self.cfg.get("dropout_max_ratio", 0.5)
        order = (self.rng.permutation(len(self)) if shuffle
                 else np.arange(len(self)))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            rows = np.sort(order[i:i + batch_size])
            raw = np.asarray(self.arr[rows], np.float32)  # (B, P, 9)
            B = raw.shape[0]
            idx = _batch_indices(self.rng, self.P, n_pts, B, dp, dr)
            take = np.take_along_axis(raw, idx[..., None], axis=1)
            xyz, nrm, nocs = take[..., :3], take[..., 3:6], take[..., 6:9]
            center = (xyz.max(1) + xyz.min(1)) / 2
            scale = np.maximum((xyz.max(1) - xyz.min(1)).max(-1), 1e-9)
            xyz = (xyz - center[:, None]) / scale[:, None, None]
            yield {"x": np.concatenate([xyz, nrm], axis=-1).astype(np.float32),
                   "nocs": nocs.astype(np.float32)}


class PackedGrasp:
    """Memmap-backed grasp-quality dataset (cloud in grasp frame, score bin)."""

    def __init__(self, out_dir: str, cfg: dict, phase: str = "train", seed: int = 0):
        self.cfg, self.phase = cfg, phase
        self.rng = np.random.default_rng(seed)
        m = _load_meta(out_dir)
        self.P = m["grasp_scene_pts"]
        self.clouds = np.memmap(os.path.join(out_dir, "grasp_cloud.bin"),
                                np.float16, "r",
                                shape=(m["n_grasp_cloud"], self.P, 6))
        keys = np.load(os.path.join(out_dir, "grasp_keys.npz"))
        self.pose, self.score = keys["pose"], keys["score"]
        self.cloud_row = keys["cloud_row"]
        self.classes = np.asarray(cfg["classes"], np.float32)

    def __len__(self):
        return len(self.pose)

    def batches(self, batch_size: int, shuffle: bool = True):
        n_pts = self.cfg.get("n_pts", 1024)
        flip_p = self.cfg.get("flip_cloud_prob", 0.5) if self.phase == "train" else 0.0
        if shuffle and self.phase == "train" and self.cfg.get("balance_bins", True):
            # class-balanced sampling: the dense-clutter projection labels
            # are dominated by bins 0 and 9 (marginal entropy 2.08 nats ==
            # the round-2 CE plateau — the net was predicting the marginal).
            # Uniform-over-bins draws force the ranking signal.  Epoch
            # length stays len(self)/batch.
            score_bin = np.digitize(self.score, self.classes) - 1
            bins = [np.where(score_bin == b)[0] for b in range(len(self.classes) - 1)]
            bins = [b for b in bins if len(b)]
            per = [b[self.rng.integers(0, len(b), (len(self) // len(bins) + 1,))]
                   for b in bins]
            order = np.concatenate(per)
            self.rng.shuffle(order)
            order = order[: len(self)]
        else:
            order = (self.rng.permutation(len(self)) if shuffle
                     else np.arange(len(self)))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            ks = order[i:i + batch_size]
            raw = self.clouds[self.cloud_row[ks]]  # f16, stays f16 until cut
            B = raw.shape[0]
            # subsample BEFORE the frame transform AND before the f32 cast:
            # converting the full (B, 8192, 6) row to f32 was half the
            # single-core loader cost
            idx = _batch_indices(self.rng, self.P, n_pts, B, 0, 0)
            raw = np.take_along_axis(raw, idx[..., None], axis=1).astype(np.float32)
            T = np.linalg.inv(self.pose[ks])  # cam -> grasp frame
            xyz = np.einsum("bij,bpj->bpi", T[:, :3, :3], raw[..., :3]) \
                + T[:, None, :3, 3]
            nrm = np.einsum("bij,bpj->bpi", T[:, :3, :3], raw[..., 3:6])
            if flip_p > 0:
                flip = self.rng.random(B) <= flip_p
                xyz[flip, :, 1] *= -1
                nrm[flip, :, 1] *= -1
            score_bin = np.digitize(self.score[ks], self.classes) - 1
            yield {"x": np.concatenate([xyz, nrm], axis=-1).astype(np.float32),
                   "label": score_bin.astype(np.int32)}
