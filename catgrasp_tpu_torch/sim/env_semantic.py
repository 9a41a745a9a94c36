"""Task poses, the placement check and the floating-gripper place
(``catgrasp_tpu/sim/env_semantic.py``).

Ported: the task poses relative to each category's place fixture, the
class-specific success check, and ``place_and_drop``, the place of the
eval's floating-gripper baseline.  Affordance discovery (``try_grasp``,
``accumulate_affordance``) belongs to affordance generation and is not
ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transforms as tf
from ..device import constant
from ..geom import csg as csglib
from . import engine
from .env_grasp import GripperSpec, finger_boxes
from .types import SceneParams, SceneState, ShapeLib

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


# The gripper boxes' sample points sit on a 32^3 lattice in each box: these
# 32 lattice cells (flat index i * 1024 + j * 32 + k), a fixed draw that
# the JAX package makes from random key 0, so both packages sample alike.
_BOX_LATTICE_CELLS = (13172, 27535, 9272, 25839, 24373, 5713, 22976, 31105, 12319, 7003, 9749,
                      17782, 9263, 11737, 15448, 28290, 20620, 6697, 4261, 28213, 9154, 12268,
                      15348, 32135, 12855, 32675, 153, 6425, 17302, 18563, 3529, 23857)
_FIXTURE_MASS = 1e9


def _gripper_sample_points(spec: GripperSpec, width: torch.Tensor) -> torch.Tensor:
    """32 points inside each of the gripper's three boxes (fingers, then
    palm) at opening ``width``, grasp frame: (96, 3)."""
    centers, halves = finger_boxes(width, spec)
    idx = constant(_BOX_LATTICE_CELLS, torch.int64, width.device)
    ijk = torch.stack([idx // 1024, (idx // 32) % 32, idx % 32], dim=-1)
    g = (ijk.to(torch.float32) + 0.5) / 32
    return ((g * 2 - 1)[None] * halves[:, None, :] + centers[:, None, :]).reshape(-1, 3)


def _drop_floor(device) -> engine.StaticEnv:
    """The floor slab the place-and-drop world stands on."""
    one = constant((1.0,), torch.float32, device)
    return engine.StaticEnv(
        center=constant(((0.0, 0.0, -0.05),), torch.float32, device),
        half=constant(((0.5, 0.5, 0.05),), torch.float32, device),
        quat=constant(((1.0, 0.0, 0.0, 0.0),), torch.float32, device),
        vel=torch.zeros((1, 3), device=device), friction=one * 0.7,
        enabled=torch.ones((1,), dtype=torch.bool, device=device),
        imp_budget=one * float("inf"), grip=torch.zeros((1,), dtype=torch.bool, device=device))


def place_and_drop(lib: ShapeLib, obj_shape: torch.Tensor, fixture_shape_idx: int,
                   scale: torch.Tensor, grasp_in_ob: torch.Tensor, class_name: str,
                   width: torch.Tensor, spec: GripperSpec = GripperSpec(),
                   n_waypoints: int = 8, drop_steps: int = 60, narrowphase: str = "csg",
                   grasp_in_ob_cmd: torch.Tensor | None = None) -> torch.Tensor:
    """The floating gripper's place over the fixture: sweep the gripper's
    three boxes (palm included) along the pre-place -> place waypoints
    against the fixture's CSG, release the object at the place pose, drop
    it ``drop_steps`` steps onto the fixture (a huge-mass body on a floor
    slab) and check the category's success bands.  Returns a bool tensor:
    not blocked and placed.

    ``grasp_in_ob`` is the actual in-hand pose after the close (slip
    included); ``grasp_in_ob_cmd`` the commanded one (default: the actual).
    The gripper is steered so that the believed object pose tracks the
    waypoints, so slip tilts and offsets the real object through the sweep
    and the drop.  ``obj_shape`` (a 0-d tensor) and ``scale`` are the
    object's shape index and scale; nothing here waits for the device."""
    dev = grasp_in_ob.device
    pre_t, place_t = (constant(tuple(float(v) for v in t), torch.float32, dev)
                      for t in TASK_POSES[class_name])
    if grasp_in_ob_cmd is None:
        grasp_in_ob_cmd = grasp_in_ob
    # believed -> actual object: where the object really is, relative to
    # where the controller thinks it holds it
    slip = grasp_in_ob_cmd @ tf.pose_inverse(grasp_in_ob)

    alphas = torch.linspace(0.0, 1.0, n_waypoints, device=dev)
    believed = torch.eye(4, device=dev).repeat(n_waypoints, 1, 1)
    believed[:, :3, 3] = pre_t[None] * (1 - alphas[:, None]) + place_t[None] * alphas[:, None]
    grip_pts_w = tf.transform_points(believed @ grasp_in_ob_cmd,
                                     _gripper_sample_points(spec, width))
    d_grip = csglib.csg_sdf(csglib.select_shape(lib.csg, fixture_shape_idx), grip_pts_w)
    blocked = torch.any(torch.amin(d_grip, dim=-1) < 5e-4)

    # release pose of the real object: the believed pose at place_t composed
    # with the in-hand slip
    release = torch.eye(4, device=dev)
    release[:3, 3] = place_t
    release = release @ slip
    shape_ids = torch.cat([torch.reshape(obj_shape, (1,)),
                           torch.full((1,), fixture_shape_idx, device=dev)])
    scales = torch.cat([torch.reshape(torch.as_tensor(scale, dtype=torch.float32), (1,)),
                        torch.ones((1,), device=dev)])
    params = SceneParams.create(lib, shape_ids, scales)
    fix = torch.arange(2, device=dev) == 1
    params = params.replace(
        mass=torch.where(fix, _FIXTURE_MASS, params.mass),
        inertia=torch.where(fix[:, None], _FIXTURE_MASS, params.inertia),
        # slippery fixture so parts slide into place (lateral friction 0.1)
        friction=torch.where(fix, 0.1, params.friction))
    st = SceneState(
        pos=torch.stack([release[:3, 3], torch.zeros(3, device=dev)]),
        quat=torch.stack([tf.matrix_to_quat(release[:3, :3]),
                          constant((1.0, 0.0, 0.0, 0.0), torch.float32, dev)]),
        linvel=torch.zeros((2, 3), device=dev), angvel=torch.zeros((2, 3), device=dev),
        active=torch.ones((2,), dtype=torch.bool, device=dev))
    final = engine.rollout(st, params, lib, _drop_floor(dev), drop_steps, gravity=-9.8,
                           narrowphase=narrowphase)
    ob_pose_final = tf.pose_from_qt(final.quat[0], final.pos[0])
    return ~blocked & place_success(class_name, ob_pose_final, place_t)
