"""Training datasets over generated scene records (``catgrasp_tpu/data/
datasets.py``, host numpy, copied): the unpacked path.

Numpy batch iterators mirroring the reference's three torch Datasets
(``dataset_nunocs.py``, ``dataset_grasp.py``, ``PointGroup/data/
dataset_seg.py``), producing fixed-shape device-ready batches.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from . import augment, labels


def _to_homo(p):
    return np.concatenate([p, np.ones_like(p[:, :1])], axis=1)


class NunocsDataset:
    """Isolated-object clouds -> (input xyz+normal normalized, nocs target).
    Reference: ``dataset_nunocs.py:17-80``."""

    def __init__(self, root: str, cfg: dict, phase: str = "train", seed: int = 0):
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        self.items = []
        for f in sorted(glob.glob(os.path.join(root, "*.npz"))):
            scene = labels.load_scene(f)
            self.items += labels.isolated_object_clouds(scene)

    def __len__(self):
        return len(self.items)

    def sample(self, idx: int) -> dict:
        d = {k: np.array(v) for k, v in self.items[idx].items() if k.startswith("cloud")}
        n_pts = self.cfg.get("n_pts", 1024)
        d = augment.resample(d, n_pts, self.rng)
        if self.phase == "train":
            d = augment.dropout_cloud(d, self.rng, self.cfg.get("dropout_prob", 0.5),
                                      self.cfg.get("dropout_max_ratio", 0.5))
        d = augment.normalize_cloud(d)
        d["input"] = np.concatenate([d["cloud_xyz"], d["cloud_normal"]], axis=-1)
        return d

    def batches(self, batch_size: int, shuffle: bool = True):
        order = self.rng.permutation(len(self)) if shuffle else np.arange(len(self))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self.sample(j) for j in order[i:i + batch_size]]
            yield {
                "x": np.stack([it["input"] for it in items]).astype(np.float32),
                "nocs": np.stack([it["cloud_nocs"] for it in items]).astype(np.float32),
            }


class GraspDataset:
    """(scene cloud in grasp frame, score bin) pairs.
    Reference: ``dataset_grasp.py:21-103``."""

    def __init__(self, root: str, grasp_db: dict, cfg: dict, phase: str = "train",
                 seed: int = 0, min_scene_points: int = 256):
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        self.classes = np.array(cfg["classes"])
        self.keys = []  # (scene_path, grasp_in_cam, score)
        for f in sorted(glob.glob(os.path.join(root, "*.npz"))):
            scene = labels.load_scene(f)
            sc = labels.scene_cloud(scene)
            if len(sc["cloud_xyz"]) < min_scene_points:
                continue
            for g, score, body in labels.dense_clutter_grasp_labels(scene, grasp_db, rng=self.rng):
                self.keys.append((f, g, score))
        self._cache = {}

    def __len__(self):
        return len(self.keys)

    def _scene(self, path):
        if path not in self._cache:
            self._cache[path] = labels.scene_cloud(labels.load_scene(path))
        return self._cache[path]

    def sample(self, idx: int) -> dict:
        path, grasp, score = self.keys[idx]
        sc = self._scene(path)
        d = {"cloud_xyz": sc["cloud_xyz"].copy(), "cloud_normal": sc["cloud_normal"].copy()}
        # transform into the grasp frame (dataset_grasp.py:69-70)
        T = np.linalg.inv(grasp)
        d["cloud_xyz"] = (_to_homo(d["cloud_xyz"]) @ T.T)[:, :3]
        d["cloud_normal"] = d["cloud_normal"] @ T[:3, :3].T
        d = augment.resample(d, self.cfg.get("n_pts", 1024), self.rng)
        if self.phase == "train":
            d = augment.flip_cloud(d, self.rng, self.cfg.get("flip_cloud_prob", 0.5), axes=("y",))
        d["input"] = np.concatenate([d["cloud_xyz"], d["cloud_normal"]], axis=-1)
        d["score_bin"] = int(np.digitize(score, self.classes) - 1)
        return d

    def batches(self, batch_size: int, shuffle: bool = True):
        order = self.rng.permutation(len(self)) if shuffle else np.arange(len(self))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self.sample(j) for j in order[i:i + batch_size]]
            yield {
                "x": np.stack([it["input"] for it in items]).astype(np.float32),
                "label": np.array([it["score_bin"] for it in items], np.int32),
            }


class SegDataset:
    """Whole-scene clouds with instance labels for the segmentation net.
    Reference: ``PointGroup/data/dataset_seg.py:131-209``."""

    def __init__(self, root: str, cfg: dict, phase: str = "train", seed: int = 0):
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        self.files = sorted(glob.glob(os.path.join(root, "*.npz")))

    def __len__(self):
        return len(self.files)

    def sample(self, idx: int) -> dict:
        scene = labels.load_scene(self.files[idx])
        sc = labels.scene_cloud(scene)
        n_pts = self.cfg.get("n_pts", 20000)
        n = len(sc["cloud_xyz"])
        ids = self.rng.choice(n, n_pts, replace=n < n_pts)
        xyz = sc["cloud_xyz"][ids]
        inst = sc["instance_id"][ids]
        # gt center offsets: vector to instance centroid (env points get 0)
        offsets = np.zeros_like(xyz)
        for i in np.unique(inst):
            if i < 0:
                continue
            m = inst == i
            offsets[m] = xyz[m].mean(axis=0) - xyz[m]
        return {
            "xyz": xyz.astype(np.float32),
            "normal": sc["cloud_normal"][ids].astype(np.float32),
            "instance_id": inst.astype(np.int32),
            "offsets": offsets.astype(np.float32),
        }

    def batches(self, batch_size: int, shuffle: bool = True):
        order = self.rng.permutation(len(self)) if shuffle else np.arange(len(self))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self.sample(j) for j in order[i:i + batch_size]]
            yield {
                "xyz": np.stack([it["xyz"] for it in items]),
                "normal": np.stack([it["normal"] for it in items]),
                "instance_id": np.stack([it["instance_id"] for it in items]),
                "offsets": np.stack([it["offsets"] for it in items]),
            }
