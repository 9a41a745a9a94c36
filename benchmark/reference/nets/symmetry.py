"""A frozen copy of the port's ``core/symmetry.py``, for the benchmark's plain
reference; later changes to the port do not reach it.

Category symmetry groups (``catgrasp_tpu/core/symmetry.py``, numpy).

Discrete symmetry transform tables per object category, used for grasp-pose
expansion in the NOCS-transfer sampler and for the place orientation loop.
"""
from __future__ import annotations

import numpy as np


def _euler_sxyz(ax: float, ay: float, az: float) -> np.ndarray:
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    R = np.array(
        [
            [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
            [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
            [-sy, sx * cy, cx * cy],
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    return T


def get_symmetry_tfs(class_name: str, allow_reflection: bool = True) -> np.ndarray:
    """Discrete symmetry group of a category, as (S, 4, 4) float32:

      * nut:   x-rot {0°,180°} x z-rot {0°,60°,...,300°}  (12 tfs)
      * hnm:   z-rot {0°,180°}                            (2 tfs)
      * screw: z-rot every 5°                             (72 tfs)

    All generated transforms are proper rotations, so ``allow_reflection``
    never removes anything.
    """
    tfs = []
    if class_name == "nut":
        for xangle in np.deg2rad([0.0, 180.0]):
            for zangle in np.deg2rad(np.arange(0, 360, 60.0)):
                tfs.append(_euler_sxyz(xangle, 0.0, zangle))
    elif class_name == "hnm":
        for rz in [0.0, np.pi]:
            tfs.append(_euler_sxyz(0.0, 0.0, rz))
    elif class_name == "screw":
        for zrot in np.deg2rad(np.arange(0, 360, 5.0)):
            tfs.append(_euler_sxyz(0.0, 0.0, zrot))
    else:
        raise ValueError(f"unknown class {class_name!r}")

    tfs = np.stack(tfs).astype(np.float32)
    if not allow_reflection:
        keep = np.linalg.det(tfs[:, :3, :3]) > 0
        tfs = tfs[keep]
    return tfs
