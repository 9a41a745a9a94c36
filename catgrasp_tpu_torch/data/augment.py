"""Point-cloud augmentations (``catgrasp_tpu/data/augment.py``, host numpy,
copied): the reference's ``augmentations.py:19-93``.

These run host-side in the data path (cheap), keeping the device graph
static.  Each takes/returns the dict convention of the reference datasets:
``cloud_xyz``, ``cloud_normal``, optional ``cloud_nocs``.
"""
from __future__ import annotations

import numpy as np


def rotate_cloud_z(data: dict, rng: np.random.Generator, prob: float = 0.5) -> dict:
    if rng.random() > prob:
        return data
    a = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    data["cloud_xyz"] = data["cloud_xyz"] @ R.T
    if "cloud_normal" in data:
        data["cloud_normal"] = data["cloud_normal"] @ R.T
    return data


def flip_cloud(data: dict, rng: np.random.Generator, prob: float = 0.5,
               axes=("y",)) -> dict:
    """Mirror along the given axes (``FlipCloud``; the grasp dataset flips y
    — the closing axis — ``dataset_grasp.py:79``)."""
    for ax in axes:
        if rng.random() > prob:
            continue
        i = "xyz".index(ax)
        data["cloud_xyz"] = data["cloud_xyz"].copy()
        data["cloud_xyz"][:, i] *= -1
        if "cloud_normal" in data:
            data["cloud_normal"] = data["cloud_normal"].copy()
            data["cloud_normal"][:, i] *= -1
    return data


def dropout_cloud(data: dict, rng: np.random.Generator, prob: float = 0.5,
                  max_ratio: float = 0.5) -> dict:
    """Random point dropout with resampling to keep the count fixed
    (``DropoutCloud``)."""
    if rng.random() > prob:
        return data
    n = len(data["cloud_xyz"])
    keep = max(int(n * (1 - rng.uniform(0, max_ratio))), 8)
    ids = rng.choice(n, keep, replace=False)
    ids = np.concatenate([ids, rng.choice(ids, n - keep)])
    for k in ("cloud_xyz", "cloud_normal", "cloud_nocs"):
        if k in data:
            data[k] = data[k][ids]
    return data


def normalize_cloud(data: dict) -> dict:
    """Shift to centroid, scale to unit max-extent box (``NormalizeCloud``,
    used by the NUNOCS dataset, ``dataset_nunocs.py:56``)."""
    xyz = data["cloud_xyz"]
    center = (xyz.max(axis=0) + xyz.min(axis=0)) / 2
    scale = max(float((xyz.max(axis=0) - xyz.min(axis=0)).max()), 1e-9)
    data["cloud_xyz"] = (xyz - center) / scale
    data["normalize_center"] = center
    data["normalize_scale"] = scale
    return data


def resample(data: dict, n_pts: int, rng: np.random.Generator) -> dict:
    n = len(data["cloud_xyz"])
    ids = rng.choice(n, n_pts, replace=n < n_pts)
    for k in ("cloud_xyz", "cloud_normal", "cloud_nocs"):
        if k in data:
            data[k] = data[k][ids]
    return data
