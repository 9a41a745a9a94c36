"""Point-cloud normalisation (``catgrasp_tpu/data/augment.py:normalize_cloud``;
host numpy, as there).  The training augmentations wait for the training
port."""
from __future__ import annotations


def normalize_cloud(data: dict) -> dict:
    """Shift to the bounding box's centre and scale to a unit max extent
    (``NormalizeCloud``, the NUNOCS net's input convention)."""
    xyz = data["cloud_xyz"]
    center = (xyz.max(axis=0) + xyz.min(axis=0)) / 2
    scale = max(float((xyz.max(axis=0) - xyz.min(axis=0)).max()), 1e-9)
    data["cloud_xyz"] = (xyz - center) / scale
    data["normalize_center"] = center
    data["normalize_scale"] = scale
    return data
