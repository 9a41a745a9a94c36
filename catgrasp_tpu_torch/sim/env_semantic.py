"""Task-affordance discovery, the placement check and the floating-gripper
place (``catgrasp_tpu/sim/env_semantic.py`` in PyTorch).

``try_grasp`` labels each grasp of a DB by what happens when it is used for
the task: hold the object at its task pose over the placement fixture,
close the gripper and shake; if the hold is stable, sweep the fingers from
the pre-place to the place pose against the fixture, open, drop, and check
the category's placement.  Outcome 0 = grasp fail, 1 = stable but task
fail, 2 = task success; the object surface points the fingers touch are
recorded, and ``accumulate_affordance`` turns the outcomes into a
per-point P(task | stable grasp).  The JAX package vmaps one grasp; here a
batch of G grasps is one scene batch at every stage:
  A. stability, in-hand drift and final width: :func:`env_grasp.grasp_rollout`
  B. insertion: the finger boxes' sample points against the fixture's CSG
     along interpolated waypoints
  C. drop: the object from its held place pose onto the fixture (a huge-mass
     body in the same engine), G scenes of 2 bodies
  D. :func:`place_success`.

``place_and_drop`` is the floating-gripper baseline's place in the eval: the
same sweep (palm included) and drop for an object already held.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transforms as tf
from ..device import constant
from ..geom import csg as csglib
from . import engine
from .env_grasp import GripperSpec, finger_boxes, finger_contact_points, grasp_rollout
from .types import SceneParams, SceneState, ShapeLib

# Provenance stamp of affordance labels: the JAX package's version of the
# try_grasp semantics these labels follow (v3: the latched per-finger
# closing law, motor-backed grip friction, exact tangential effective mass,
# split-impulse Baumgarte, the friction passivity guard).
TRY_GRASP_VERSION = 3

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


def _gripper_sample_points(spec: GripperSpec, width: torch.Tensor, n_boxes: int = 3,
                           center=0.0) -> torch.Tensor:
    """32 points inside each of the gripper's first ``n_boxes`` boxes
    (fingers, then palm) at opening ``width`` (...) with the finger midline
    at ``center``, grasp frame: (..., 32 * n_boxes, 3).  ``n_boxes=2`` is
    the fingers only, the insertion sweep of affordance discovery."""
    centers, halves = finger_boxes(width, spec, center)
    centers, halves = centers[..., :n_boxes, :], halves[..., :n_boxes, :]
    idx = constant(_BOX_LATTICE_CELLS, torch.int64, centers.device)
    ijk = torch.stack([idx // 1024, (idx // 32) % 32, idx % 32], dim=-1)
    g = (ijk.to(torch.float32) + 0.5) / 32
    pts = (g * 2 - 1) * halves[..., :, None, :] + centers[..., :, None, :]
    return pts.reshape(centers.shape[:-2] + (-1, 3))


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


def drop_on_fixture(lib: ShapeLib, obj_shape, fixture_shape_idx: int, scale,
                    release: torch.Tensor, drop_steps: int = 60,
                    narrowphase: str = "csg") -> torch.Tensor:
    """Release the object at ``release`` (..., 4, 4), fixture frame, and
    drop it ``drop_steps`` steps onto the fixture: a huge-mass, slippery
    (friction 0.1) body at the origin on a floor slab.  Each leading index
    is a scene of 2 bodies; returns the object's final pose (..., 4, 4)."""
    dev = release.device
    lead = release.shape[:-2]
    shape_ids = torch.cat([torch.reshape(torch.as_tensor(obj_shape, device=dev), (1,)),
                           torch.full((1,), fixture_shape_idx, device=dev)])
    scales = torch.cat([torch.reshape(torch.as_tensor(scale, dtype=torch.float32, device=dev),
                                      (1,)),
                        torch.ones((1,), device=dev)])
    params = SceneParams.create(lib, shape_ids, scales)
    fix = torch.arange(2, device=dev) == 1
    params = params.replace(
        mass=torch.where(fix, _FIXTURE_MASS, params.mass),
        inertia=torch.where(fix[:, None], _FIXTURE_MASS, params.inertia),
        # slippery fixture so parts slide into place (lateral friction 0.1)
        friction=torch.where(fix, 0.1, params.friction))
    params = SceneParams(**{k: v.expand(*lead, *v.shape) for k, v in vars(params).items()})
    ident = constant((1.0, 0.0, 0.0, 0.0), torch.float32, dev)
    st = SceneState(
        pos=torch.stack([release[..., :3, 3], torch.zeros(lead + (3,), device=dev)], dim=-2),
        quat=torch.stack([tf.matrix_to_quat(release[..., :3, :3]), ident.expand(lead + (4,))],
                         dim=-2),
        linvel=torch.zeros(lead + (2, 3), device=dev),
        angvel=torch.zeros(lead + (2, 3), device=dev),
        active=torch.ones(lead + (2,), dtype=torch.bool, device=dev))
    final = engine.rollout(st, params, lib, _drop_floor(dev), drop_steps, gravity=-9.8,
                           narrowphase=narrowphase)
    return tf.pose_from_qt(final.quat[..., 0, :], final.pos[..., 0, :])


def _translate(t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, device=t.device)
    T[:3, 3] = t
    return T


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
    release = _translate(place_t) @ slip
    ob_pose_final = drop_on_fixture(lib, obj_shape, fixture_shape_idx, scale, release,
                                    drop_steps, narrowphase)
    return ~blocked & place_success(class_name, ob_pose_final, place_t)


def grasp_contacts(grasp_in_ob: torch.Tensor, drift: torch.Tensor, width: torch.Tensor,
                   center: torch.Tensor, aff_pts: torch.Tensor, scale,
                   spec: GripperSpec = GripperSpec()):
    """Masks (..., P) of the affordance points ``aff_pts`` (P, 3), object
    frame, that the +y and the -y finger touch (within 3 mm of the inner
    face) when the object sits at its post-close pose ``drift`` (..., 4, 4)
    in the gripper at ``grasp_in_ob`` with opening ``width`` and finger
    midline ``center`` (...)."""
    pts_w = tf.transform_points(drift, aff_pts * scale)
    pts_g = tf.transform_points(tf.pose_inverse(grasp_in_ob), pts_w)
    return finger_contact_points(pts_g, width[..., None], spec, surface_tol=0.003,
                                 center=center[..., None])


def insertion_blocked(lib: ShapeLib, fixture_shape_idx: int, grasp_in_ob: torch.Tensor,
                      drift: torch.Tensor, width: torch.Tensor, center: torch.Tensor,
                      class_name: str, spec: GripperSpec = GripperSpec(),
                      n_waypoints: int = 8) -> torch.Tensor:
    """The insertion sweep: the object rides rigidly at its drifted in-hand
    pose ``drift`` (..., 4, 4) while the gripper translates from the
    pre-place to the place pose; the fingers' sample points (the palm is
    free to brush the fixture) are tested against the fixture's CSG at
    ``n_waypoints`` waypoints.  Returns (...) bool: a finger point came
    within 0.5 mm of the fixture."""
    dev = drift.device
    pre_t, place_t = (constant(tuple(float(v) for v in t), torch.float32, dev)
                      for t in TASK_POSES[class_name])
    alphas = torch.linspace(0.0, 1.0, n_waypoints, device=dev)
    path = tf.interpolate_poses(_translate(pre_t) @ drift, _translate(place_t) @ drift,
                                alphas)  # (..., K, 4, 4)
    # the grasp pose in the fixture frame while the object is held here
    grasp_w = path @ tf.pose_inverse(drift)[..., None, :, :] @ grasp_in_ob[..., None, :, :]
    grip_pts_g = _gripper_sample_points(spec, width, n_boxes=2, center=center)
    gp_w = tf.transform_points(grasp_w, grip_pts_g[..., None, :, :])
    d_grip = csglib.csg_sdf(csglib.select_shape(lib.csg, fixture_shape_idx), gp_w)
    return torch.any(torch.amin(d_grip, dim=-1) < 5e-4, dim=-1)


def try_grasp_after_rollout(lib: ShapeLib, roll: dict, obj_shape, fixture_shape_idx: int,
                            scale, grasp_in_ob: torch.Tensor, class_name: str,
                            aff_pts: torch.Tensor, spec: GripperSpec = GripperSpec(),
                            n_waypoints: int = 8, drop_steps: int = 60,
                            narrowphase: str = "csg") -> dict:
    """Stages after the close-and-shake rollout ``roll`` (the dict of
    :func:`env_grasp.grasp_rollout` over (...) grasps): the contacts at the
    post-close state, the insertion sweep, the drop from the held place
    pose, the placement check.  Returns a dict of (...) tensors: ``ret``,
    ``stable``, ``blocked``, ``placed``, the contact masks ``m_pos``,
    ``m_neg`` and ``contact_mask`` (..., P), the drop's start pose
    ``release`` and the object's final pose ``ob_pose_final``."""
    place_t = constant(tuple(float(v) for v in TASK_POSES[class_name][1]), torch.float32,
                       grasp_in_ob.device)
    # the object fell out (moved > 0.2 m during the shake), or the open
    # gripper already collided; past that, everything uses the post-close
    # state (the hold test restores it)
    held = ~roll["collided"] & (roll["displacement"] <= 0.2)
    drift = roll["ob_pose_close"]
    m_pos, m_neg = grasp_contacts(grasp_in_ob, drift, roll["width"], roll["center"], aff_pts,
                                  scale, spec)
    stable = held & torch.any(m_pos, dim=-1) & torch.any(m_neg, dim=-1)
    blocked = insertion_blocked(lib, fixture_shape_idx, grasp_in_ob, drift, roll["width"],
                                roll["center"], class_name, spec, n_waypoints)
    # the drop starts from the held pose after the insertion (drifted)
    release = _translate(place_t) @ drift
    ob_pose_final = drop_on_fixture(lib, obj_shape, fixture_shape_idx, scale, release,
                                    drop_steps, narrowphase)
    placed = place_success(class_name, ob_pose_final, place_t)
    ret = torch.where(stable, torch.where(blocked | ~placed, 1, 2), 0)
    return {"ret": ret, "stable": stable, "blocked": blocked, "placed": placed,
            "m_pos": m_pos, "m_neg": m_neg, "contact_mask": (m_pos | m_neg) & stable[..., None],
            "release": release, "ob_pose_final": ob_pose_final}


def try_grasp(lib: ShapeLib, obj_shape, fixture_shape_idx: int, scale,
              grasp_in_ob: torch.Tensor, class_name: str, aff_pts: torch.Tensor,
              spec: GripperSpec = GripperSpec(), n_waypoints: int = 8, drop_steps: int = 60,
              narrowphase: str = "csg"):
    """Grasps (G, 4, 4) in the object frame -> (ret (G,) in {0, 1, 2},
    contact mask over ``aff_pts`` (G, P)).  The G grasps are one scene batch
    at every stage.

    ``lib`` holds the object shape (index ``obj_shape``) and the fixture
    shape (index ``fixture_shape_idx``, with its CSG tree); ``aff_pts``
    (P, 3) are dense object surface points for the affordance labels."""
    dev = grasp_in_ob.device
    # the object's index and scale as device scalars, copied once
    if not isinstance(obj_shape, torch.Tensor):
        obj_shape = constant((int(obj_shape),), torch.int64, dev)[0]
    if not isinstance(scale, torch.Tensor):
        scale = constant((float(scale),), torch.float32, dev)[0]
    roll = grasp_rollout(lib, obj_shape, scale, grasp_in_ob, spec, narrowphase=narrowphase)
    out = try_grasp_after_rollout(lib, roll, obj_shape, fixture_shape_idx, scale, grasp_in_ob,
                                  class_name, aff_pts, spec, n_waypoints, drop_steps,
                                  narrowphase)
    return out["ret"], out["contact_mask"]


def accumulate_affordance(rets: np.ndarray, contact_masks: np.ndarray, min_trials: int = 10):
    """Per-point P(task | stable grasp) from trial outcomes: rets (G,),
    contact_masks (G, P) -> (affordance (P,) float32, n_stable (P,)).
    Points touched by fewer than ``min_trials`` stable grasps are neutral
    0.5."""
    stable = rets >= 1
    task = rets == 2
    n_stable = (contact_masks & stable[:, None]).sum(axis=0)
    n_task = (contact_masks & task[:, None]).sum(axis=0)
    aff = np.where(n_stable >= min_trials, n_task / np.maximum(n_stable, 1), 0.5)
    return aff.astype(np.float32), n_stable
