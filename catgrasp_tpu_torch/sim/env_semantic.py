"""Task poses and the placement check (``catgrasp_tpu/sim/env_semantic.py``).

Only what the arm-executed place of the eval loop needs is ported: the task
poses relative to each category's place fixture and the class-specific
success check.  Affordance discovery (``try_grasp``, ``place_and_drop``)
belongs to affordance generation and the floating-gripper baseline, and is
not ported.
"""
from __future__ import annotations

import numpy as np
import torch

# Task poses relative to the fixture origin: (pre-place, place) object
# positions.  The place (release) pose already captures the part on the
# fixture feature.
TASK_POSES = {
    # nut: peg (tip 0.07) is 4.5 cm through the hole at release
    "nut": (np.array([0, 0, 0.15]), np.array([0, 0, 0.055])),
    # screw: shaft tip 1.5+ cm into the hole (block top 0.03) at release
    "screw": (np.array([0, 0, 0.15]), np.array([0, 0, 0.045])),
    # connector: body bottom inside the socket opening (top 0.025)
    "hnm": (np.array([0, 0, 0.12]), np.array([0, 0, 0.04])),
}

# success bands (meters): object settled INTO the feature, not on top of it
# (max) and not fallen past/through it (min: resting on the fixture base)
_SUCCESS_Z_MAX = {"nut": 0.03, "screw": 0.04, "hnm": 0.035}
_SUCCESS_Z_MIN = {"nut": 0.005, "screw": 0.005, "hnm": 0.005}
# xy-center tolerances: nut/hnm 5 mm, screw 10 mm
_SUCCESS_XY = {"nut": 0.005, "screw": 0.01, "hnm": 0.005}
_COS80 = float(torch.cos(torch.deg2rad(torch.tensor(80.0))))  # in f32, as JAX rounds it


def place_success(class_name: str, ob_pose: torch.Tensor, place_pos: torch.Tensor) -> torch.Tensor:
    """Class-specific placement check of object poses (..., 4, 4) in the
    fixture frame: xy-center proximity; z-axis not perpendicular for
    screw/hnm (the nut has no orientation check); and a height band proving
    the part threaded or seated."""
    d = ob_pose[..., :2, 3] - place_pos[:2]
    xy_ok = torch.sqrt(torch.sum(d * d, dim=-1)) <= _SUCCESS_XY[class_name]
    if class_name == "nut":
        axis_ok = torch.ones_like(xy_ok)
    else:
        axis_ok = torch.abs(ob_pose[..., 2, 2]) >= _COS80
    z = ob_pose[..., 2, 3]
    z_ok = (z <= _SUCCESS_Z_MAX[class_name]) & (z >= _SUCCESS_Z_MIN[class_name])
    return xy_ok & z_ok & axis_ok
