"""Packed memmap training data (``catgrasp_tpu/data/packed.py``, host numpy,
copied): the scale path for reference-size datasets.

The lazy npz datasets (`datasets.py`) decompress whole scenes per sample,
which is fine at hundreds of scenes and hopeless at the reference's 20k
(``config.yml:11-14``).  This module is the ``tool.py``
make-*-training-data analog done once at scale: a single pass over the
scene records writes fixed-shape binary rows, and training iterates
zero-copy memmap slices with the SAME augmentation semantics as
`datasets.py` (resample / dropout / normalize / y-flip), vectorized over
the batch.  Each batch's parts are spans of ``utils/profiling.py``:
``input.read`` (the memmapped rows), ``input.resample`` (each row's points)
and ``input.transform`` (frame, flip, normalisation, labels), each closed
before the batch is yielded.  The grasp rows' frame transform is computed
coordinate by coordinate in float32 (`_to_grasp_frame`), byte-identical to
``np.einsum("bij,bpj->bpi", R, p) + t``.

Layout under ``{out_dir}/``:
  meta.json                  counts + row shapes
  nunocs.bin   (M, P0, 9)  f16   [xyz | normal | nocs] per visible object
  seg.bin      (S, P1, 10) f16   [xyz | normal | gt-offset | instance]
  grasp_cloud.bin (Sg, P2, 6) f16  scene cloud rows for the grasp net
  grasp_keys.npz             pose (K,4,4) f32, score (K,), cloud_row (K,)
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from . import labels
from ..utils import profiling

META = "meta.json"


def pack_split(root: str, out_dir: str, grasp_db=None,
               nunocs_pts: int = 2048, seg_pts: int = 20000,
               grasp_scene_pts: int = 8192, seed: int = 0,
               log_every: int = 1000) -> dict:
    """One pass over ``{root}/*.npz`` -> packed rows in ``out_dir``.

    ``grasp_db``: a single grasp-DB dict, or a list of per-shape dicts each
    carrying ``shape_id`` so labels project only onto matching instances
    (our piles mix category instances; the reference's are single-instance,
    ``tool.py:290-298``)."""
    rng = np.random.default_rng(seed)
    grasp_dbs = ([grasp_db] if isinstance(grasp_db, dict) else grasp_db) or []
    files = sorted(glob.glob(os.path.join(root, "*.npz")))
    os.makedirs(out_dir, exist_ok=True)
    f_nun = open(os.path.join(out_dir, "nunocs.bin"), "wb")
    f_seg = open(os.path.join(out_dir, "seg.bin"), "wb")
    f_gcl = open(os.path.join(out_dir, "grasp_cloud.bin"), "wb")
    n_nun = n_seg = n_gcl = 0
    g_pose, g_score, g_row = [], [], []

    for fi, path in enumerate(files):
        scene = labels.load_scene(path)

        for item in labels.isolated_object_clouds(scene):
            n = len(item["cloud_xyz"])
            ids = rng.choice(n, nunocs_pts, replace=n < nunocs_pts)
            row = np.concatenate([item["cloud_xyz"][ids],
                                  item["cloud_normal"][ids],
                                  item["cloud_nocs"][ids]], axis=1)
            f_nun.write(row.astype(np.float16).tobytes())
            n_nun += 1

        sc = labels.scene_cloud(scene)
        n = len(sc["cloud_xyz"])
        if n >= 64:
            ids = rng.choice(n, seg_pts, replace=n < seg_pts)
            xyz = sc["cloud_xyz"][ids]
            inst = sc["instance_id"][ids]
            offsets = np.zeros_like(xyz)
            for i in np.unique(inst):
                if i < 0:
                    continue
                m = inst == i
                offsets[m] = xyz[m].mean(axis=0) - xyz[m]
            row = np.concatenate([xyz, sc["cloud_normal"][ids], offsets,
                                  inst[:, None].astype(np.float32)], axis=1)
            f_seg.write(row.astype(np.float16).tobytes())
            n_seg += 1

            if grasp_dbs:
                lab = []
                for db in grasp_dbs:
                    lab += labels.dense_clutter_grasp_labels(scene, db, rng=rng)
                if len(lab) > 20:  # reference cap is 20/scene TOTAL (tool.py:290)
                    lab = [lab[j] for j in rng.choice(len(lab), 20, replace=False)]
                if lab:
                    gids = rng.choice(n, grasp_scene_pts, replace=n < grasp_scene_pts)
                    row = np.concatenate([sc["cloud_xyz"][gids],
                                          sc["cloud_normal"][gids]], axis=1)
                    f_gcl.write(row.astype(np.float16).tobytes())
                    for g, score, _body in lab:
                        g_pose.append(g)
                        g_score.append(score)
                        g_row.append(n_gcl)
                    n_gcl += 1
        if log_every and (fi + 1) % log_every == 0:
            print(f"packed {fi + 1}/{len(files)} scenes "
                  f"({n_nun} objects, {len(g_pose)} grasps)", flush=True)

    f_nun.close(); f_seg.close(); f_gcl.close()
    if g_pose:
        np.savez(os.path.join(out_dir, "grasp_keys.npz"),
                 pose=np.stack(g_pose).astype(np.float32),
                 score=np.asarray(g_score, np.float32),
                 cloud_row=np.asarray(g_row, np.int64))
    meta = {"n_nunocs": n_nun, "nunocs_pts": nunocs_pts,
            "n_seg": n_seg, "seg_pts": seg_pts,
            "n_grasp_cloud": n_gcl, "grasp_scene_pts": grasp_scene_pts,
            "n_grasp_keys": len(g_pose), "n_scenes": len(files)}
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f)
    return meta


def _load_meta(out_dir: str) -> dict:
    with open(os.path.join(out_dir, META)) as f:
        return json.load(f)


def is_packed(out_dir: str) -> bool:
    return os.path.exists(os.path.join(out_dir, META))


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


def _to_grasp_frame(raw, T):
    """(B, n, 6) [xyz | normal] rows of any float dtype -> a new (B, n, 6)
    float32 array in the frames ``T`` (B, 4, 4): xyz -> R xyz + t, normal ->
    R normal.

    Byte-identical to ``np.einsum("bij,bpj->bpi", R, p) (+ t)`` on the rows
    cast to float32, at a fraction of its cost (its strided generic loop was
    most of the grasp batch's host time): output coordinate i is
    ``((p0*R[i,0] + p1*R[i,1]) + p2*R[i,2]) (+ t[i])`` in float32, that
    order, each product of exactly widened inputs, and ``+ 0.0`` last, since
    einsum's sum starts from +0 and so never ends on -0.  Worked 16 rows
    at a time in planar columns, which stay in cache."""
    block = 16
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    B, n = raw.shape[:2]
    x = np.empty((B, n, 6), np.float32)
    cols = np.empty((6, block, n), np.float32)
    acc, prod = np.empty((2, block, n), np.float32)
    for b0 in range(0, B, block):
        b1 = min(b0 + block, B)
        m = b1 - b0
        p, c, q = cols[:, :m], acc[:m], prod[:m]
        p[...] = np.moveaxis(raw[b0:b1], -1, 0)
        Rb, tb = R[b0:b1], t[b0:b1]
        for o in (0, 3):  # points, then normals
            for i in range(3):
                np.multiply(p[o], Rb[..., i, 0], out=c)
                np.multiply(p[o + 1], Rb[..., i, 1], out=q)
                c += q
                np.multiply(p[o + 2], Rb[..., i, 2], out=q)
                c += q
                if o == 0:
                    c += tb[..., i]
                np.add(c, 0.0, out=x[b0:b1, :, o + i])
    return x


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
            with profiling.span("input.read"):
                raw = np.asarray(self.arr[rows], np.float32)  # (B, P, 9)
            with profiling.span("input.resample"):
                idx = _batch_indices(self.rng, self.P, n_pts, raw.shape[0], dp, dr)
                take = np.take_along_axis(raw, idx[..., None], axis=1)
            with profiling.span("input.transform"):
                xyz, nrm, nocs = take[..., :3], take[..., 3:6], take[..., 6:9]
                center = (xyz.max(1) + xyz.min(1)) / 2
                scale = np.maximum((xyz.max(1) - xyz.min(1)).max(-1), 1e-9)
                xyz = (xyz - center[:, None]) / scale[:, None, None]
                batch = {"x": np.concatenate([xyz, nrm], axis=-1).astype(np.float32),
                         "nocs": nocs.astype(np.float32)}
            yield batch


class PackedSeg:
    """Memmap-backed whole-scene segmentation dataset."""

    def __init__(self, out_dir: str, cfg: dict, phase: str = "train", seed: int = 0):
        self.cfg, self.phase = cfg, phase
        self.rng = np.random.default_rng(seed)
        m = _load_meta(out_dir)
        self.P = m["seg_pts"]
        self.arr = np.memmap(os.path.join(out_dir, "seg.bin"), np.float16,
                             "r", shape=(m["n_seg"], self.P, 10))

    def __len__(self):
        return self.arr.shape[0]

    def batches(self, batch_size: int, shuffle: bool = True):
        n_pts = self.cfg.get("n_pts", 20000)
        order = (self.rng.permutation(len(self)) if shuffle
                 else np.arange(len(self)))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            rows = np.sort(order[i:i + batch_size])
            with profiling.span("input.read"):
                raw = np.asarray(self.arr[rows], np.float32)
            if n_pts < self.P:
                with profiling.span("input.resample"):
                    idx = _batch_indices(self.rng, self.P, n_pts, raw.shape[0], 0, 0)
                    raw = np.take_along_axis(raw, idx[..., None], axis=1)
            yield {"xyz": raw[..., :3], "normal": raw[..., 3:6],
                   "offsets": raw[..., 6:9],
                   "instance_id": raw[..., 9].astype(np.int32)}


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
            with profiling.span("input.read"):
                raw = self.clouds[self.cloud_row[ks]]  # f16, stays f16 until cut
            B = raw.shape[0]
            # subsample BEFORE the frame transform: the rows stay f16 until
            # the transform reads the kept points into float32
            with profiling.span("input.resample"):
                idx = _batch_indices(self.rng, self.P, n_pts, B, 0, 0)
                raw = np.take_along_axis(raw, idx[..., None], axis=1)
            with profiling.span("input.transform"):
                T = np.linalg.inv(self.pose[ks])  # cam -> grasp frame
                x = _to_grasp_frame(raw, T)
                if flip_p > 0:
                    flip = self.rng.random(B) <= flip_p
                    x[flip, :, 1::3] *= -1  # the y of the points and normals
                score_bin = np.digitize(self.score[ks], self.classes) - 1
                batch = {"x": x, "label": score_bin.astype(np.int32)}
            yield batch
