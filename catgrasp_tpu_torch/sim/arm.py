"""Kinematic arm execution inside the pile scene (``catgrasp_tpu/sim/arm.py``
in PyTorch).

The planned motion is executed: every engine step the arm's link boxes
(from FK frames) and the gripper's finger boxes are kinematic colliders with
finite-difference velocities, so transport collisions, descent disturbance
of the pile and arm-vs-bin contact are simulated, not assumed.

The host plans a joint-space schedule; the executors step it in a Python
loop over engine steps.  The step index is a Python int, so phase switches
are plain ``if``s; the closing latch, the width, the grip and the gate
quantities stay tensors, so no step waits for the device.  Everything that
does not depend on the simulated state (tool poses, arm boxes, the held
object's ride poses) is computed for the whole schedule at once.
``dynamicize_schedule`` replaces a planned schedule with the one a
force-limited PD-controlled articulated arm achieves tracking it
(``run_grasp_simulation --arm_dynamics 1``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transforms as tf
from ..device import constant
from ..kin import dynamics, iiwa
from . import engine
from .env_grasp import GripperSpec, closing_step, closing_touched_init, gripper_env
from .types import SceneParams, SceneState, ShapeLib

# segment radii base->S, S->E, E->W, W->F (matches kin.planner.LINK_RADII)
ARM_RADII = np.array([0.09, 0.07, 0.06, 0.05], dtype=np.float32)


def merge_envs(*envs: engine.StaticEnv) -> engine.StaticEnv:
    """Concatenate StaticEnv collider sets along the collider axis; leading
    scene axes, where a set has them, broadcast."""
    lead = torch.broadcast_shapes(*(e.friction.shape[:-1] for e in envs))

    def cat(name, vector):
        parts = [getattr(e, name) for e in envs]
        dim = -2 if vector else -1
        return torch.cat([x.expand(*lead, *x.shape[dim:]) for x in parts], dim=dim)

    return engine.StaticEnv(
        center=cat("center", True), half=cat("half", True), quat=cat("quat", True),
        vel=cat("vel", True), friction=cat("friction", False), enabled=cat("enabled", False),
        imp_budget=cat("imp_budget", False), grip=cat("grip", False))


def _rot_align_x(d: torch.Tensor) -> torch.Tensor:
    """Rotation whose +x axis is the unit direction d (..., 3)."""
    ez = constant((0.0, 0.0, 1.0), d.dtype, d.device)
    ex = constant((1.0, 0.0, 0.0), d.dtype, d.device)
    ref = torch.where(torch.abs(d[..., 2:3]) < 0.9, ez, ex)
    y = tf.cross(ref, d)
    y = y / (tf.norm(y, keepdim=True) + 1e-9)
    z = tf.cross(d, y)
    return torch.stack([d, y, z], dim=-1)  # columns


def arm_link_boxes(q: torch.Tensor, base_in_world: torch.Tensor):
    """Oriented boxes enclosing the arm's link capsules at configs q (..., 7):
    (centers (..., 4, 3), halves (..., 4, 3), quats (..., 4, 4)) in the
    WORLD frame."""
    T_S, T_E, T_W, T_F = iiwa.fk_frames(q)
    Rb, tb = base_in_world[:3, :3], base_in_world[:3, 3]
    anchors = torch.stack([torch.zeros_like(T_S[..., :3, 3]), T_S[..., :3, 3],
                           T_E[..., :3, 3], T_W[..., :3, 3], T_F[..., :3, 3]], dim=-2)
    anchors = anchors @ Rb.T + tb
    a, b = anchors[..., :-1, :], anchors[..., 1:, :]
    seg = b - a
    ln = tf.norm(seg, keepdim=True)
    d = seg / torch.clamp(ln, min=1e-9)
    R = _rot_align_x(d)
    r = constant(tuple(ARM_RADII.tolist()), torch.float32, q.device)
    centers = (a + b) / 2
    halves = torch.cat([ln / 2 + r[:, None] * 0.5,
                        torch.stack([r, r], dim=-1).expand(ln.shape[:-1] + (2,))], dim=-1)
    return centers, halves, tf.matrix_to_quat(R)


def arm_env(q: torch.Tensor, q_prev: torch.Tensor, base_in_world: torch.Tensor,
            dt: float, friction: float = 0.4) -> engine.StaticEnv:
    """The arm as 4 kinematic world boxes with finite-difference velocity."""
    c, h, qt = arm_link_boxes(q, base_in_world)
    c_prev, _, _ = arm_link_boxes(q_prev, base_in_world)
    return _arm_env_of(c, h, qt, (c - c_prev) / dt, friction)


def _arm_env_of(c, h, qt, vel, friction: float = 0.4) -> engine.StaticEnv:
    dev = c.device
    return engine.StaticEnv(
        center=c, half=h, quat=qt, vel=vel,
        friction=torch.full((4,), friction, device=dev),
        enabled=torch.ones((4,), dtype=torch.bool, device=dev),
        imp_budget=torch.full((4,), float("inf"), device=dev),
        grip=torch.zeros((4,), dtype=torch.bool, device=dev),
    )


def grasp_pose_of(q: torch.Tensor, base_in_world: torch.Tensor,
                  ee_in_grasp: torch.Tensor) -> torch.Tensor:
    """World grasp-frame pose at arm configs q (..., 7): T_grasp = T_ee @
    ee_in_grasp^-1."""
    return base_in_world @ iiwa.fk(q) @ tf.pose_inverse(ee_in_grasp)


def resample_traj(waypoints: np.ndarray, n: int) -> np.ndarray:
    """Joint-space arc-length uniform resample of a waypoint path to n
    configs."""
    w = np.asarray(waypoints, np.float32)
    if len(w) == 1:
        return np.repeat(w, n, axis=0)
    d = np.linalg.norm(np.diff(w, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    total = max(s[-1], 1e-9)
    ts = np.linspace(0.0, total, n)
    out = np.empty((n, 7), np.float32)
    for j in range(7):
        out[:, j] = np.interp(ts, s, w[:, j])
    return out


def dynamicize_schedule(qs: torch.Tensor) -> torch.Tensor:
    """The trajectory (T, 7) a force-limited PD-controlled articulated iiwa
    achieves tracking the joint schedule ``qs`` (T, 7) from rest at
    ``qs[0]`` (:func:`kin.dynamics.track_schedule`, on ``qs``'s device):
    the executors then step the dynamically achieved configurations through
    the scene instead of the ideal kinematic playback.  The waypoints are
    the engine's steps, ``engine.DT`` apart."""
    achieved, _ = dynamics.track_schedule(qs[0], qs, dt=engine.DT)
    return achieved


def _schedule(qs: torch.Tensor, base_in_world: torch.Tensor, ee_in_grasp: torch.Tensor,
              dt: float):
    """Per step of a schedule (T, 7): the tool (grasp-frame) pose, the next
    step's, and the arm's colliders (centers, halves, quats, velocities)."""
    G = grasp_pose_of(qs, base_in_world, ee_in_grasp)
    G_next = torch.cat([G[1:], G[-1:]])
    c, h, qt = arm_link_boxes(qs, base_in_world)
    vel = (c - torch.cat([c[:1], c[:-1]])) / dt
    return G, G_next, (c, h, qt, vel)


def _ride(G: torch.Tensor, G_next: torch.Tensor, ob_in_grasp: torch.Tensor, dt: float):
    """Pose rows of an object attached to the tool along G (T, 4, 4): its
    positions, quaternions and the velocities of the forward difference
    (zero at the stop before release)."""
    att = G @ ob_in_grasp
    pos = att[..., :3, 3]
    ride_vel = ((G_next @ ob_in_grasp)[..., :3, 3] - pos) / dt
    return pos, tf.matrix_to_quat(att[..., :3, :3]), ride_vel


def _attach(st: SceneState, target: int, pos, quat, linvel, where=None) -> SceneState:
    """Overwrite the target's row after a step: pose, ride velocity, no
    spin; ``where`` (a bool tensor) keeps the stepped row where false."""
    rows = (pos, quat, linvel, torch.zeros_like(linvel))
    out = {}
    for name, row in zip(("pos", "quat", "linvel", "angvel"), rows):
        v = getattr(st, name).clone()
        v[target] = row if where is None else torch.where(where, row, v[target])
        out[name] = v
    return st.replace(**out)


def _target_points_local(lib: ShapeLib, params: SceneParams, target: int) -> torch.Tensor:
    # a one-element index tensor: a 0-d one would be read on the host
    return lib.surf_pts[params.shape_id[target:target + 1]][0] * params.scale[target]


def execute_pick_arm(lib: ShapeLib, state: SceneState, params: SceneParams,
                     env_bin: engine.StaticEnv, target: int, qs: torch.Tensor,
                     base_in_world: torch.Tensor, ee_in_grasp: torch.Tensor,
                     spec: GripperSpec = GripperSpec(), n_app: int = 160, n_close: int = 50,
                     n_hold: int = 80, narrowphase: str = "csg", trace: list | None = None):
    """Arm-executed pick: approach along ``qs[:n_app]`` (RRT + descent,
    resampled), close, gravity-hold gate, then lift along the rest with the
    object attached while it stays a collider for the rest of the pile.

    ``qs`` (T, 7) with T = n_app + n_close + n_hold + n_lift; the close/hold
    span repeats the grasp config.  Returns (picked, final_state,
    ob_in_grasp, width, center, disturbance) as tensors: ``center`` is the
    finger-midline y offset the per-finger close settled at, and
    ``disturbance`` the largest displacement of a non-target body during
    the approach.  A ``trace`` list gets the target's position after every
    step (a (3,) tensor a step)."""
    dt = engine.DT
    dev = qs.device
    T = qs.shape[0]
    G, G_next, (ac, ah, aq, av) = _schedule(qs, base_in_world, ee_in_grasp, dt)
    G_inv = tf.pose_inverse(G)
    local = _target_points_local(lib, params, target)
    not_target = torch.arange(state.pos.shape[0], device=dev) != target
    pos0 = state.pos

    t_close0, t_hold0, t_lift0 = n_app, n_app + n_close, n_app + n_close + n_hold
    st = state
    w = torch.full((), spec.max_width, device=dev)
    c = torch.zeros((), device=dev)
    tch = closing_touched_init(dev)
    ob_in_grasp = torch.eye(4, device=dev)
    pos_close = torch.zeros(3, device=dev)
    disturb = torch.zeros((), device=dev)
    ride = None
    for i in range(T):
        # the closing law against the CURRENT tool pose
        R = tf.quat_to_matrix(st.quat[target])
        pts_g = tf.transform_points(G_inv[i], st.pos[target] + local @ R.T)
        w, c, tch, v_p, v_n = closing_step(pts_g, w, c, tch, t_close0 <= i < t_hold0, spec, dt)
        grip = tch[0] & tch[1] if i >= t_hold0 else False
        genv = gripper_env(G[i], w, c, v_p, v_n, spec, grip=grip)
        merged = merge_envs(env_bin, genv, _arm_env_of(ac[i], ah[i], aq[i], av[i]))
        st = engine.step(st, params, lib, merged, dt=dt, gravity=-9.8, narrowphase=narrowphase)
        if i >= t_lift0:
            # attachment during lift: the held object rides the tool frame
            st = _attach(st, target, *(x[i - t_lift0] for x in ride))
        if i == t_hold0 - 1:
            pos_close = st.pos[target].clone()
        if i == t_lift0 - 1:
            ob_pose = tf.pose_from_qt(st.quat[target], st.pos[target])
            ob_in_grasp = G_inv[i] @ ob_pose
            ride = _ride(G[t_lift0:], G_next[t_lift0:], ob_in_grasp, dt)
        if i < t_close0:
            moved = tf.norm(st.pos - pos0)
            disturb = torch.maximum(disturb, torch.amax(
                torch.where(not_target & st.active, moved, 0.0)))
        if trace is not None:
            trace.append(st.pos[target])

    # hold gate at the END OF HOLD (pre-lift), the floating gripper's verify
    # semantics
    ob_hold = G[t_lift0 - 1] @ ob_in_grasp
    disp = tf.norm(ob_hold[:3, 3] - pos_close)
    closed_on_something = w > 1e-3
    # the hold may sit at the finger midline offset c, so the lateral bound
    # is measured from there
    ref = torch.stack([torch.full((), 0.02, device=dev), c, torch.zeros((), device=dev)])
    bound = constant((0.06, 0.05, 0.05), torch.float32, dev)
    centered = torch.all(torch.abs(ob_in_grasp[:3, 3] - ref) < bound)
    picked = (disp < 0.02) & closed_on_something & centered
    return picked, st, ob_in_grasp, w, c, disturb


def execute_place_arm(lib: ShapeLib, state: SceneState, params: SceneParams,
                      env_bin: engine.StaticEnv, target: int, qs: torch.Tensor,
                      base_in_world: torch.Tensor, ee_in_grasp: torch.Tensor,
                      ob_in_grasp: torch.Tensor, width: torch.Tensor,
                      spec: GripperSpec = GripperSpec(), n_move: int = 160,
                      n_drop: int = 100, narrowphase: str = "csg", center=0.0):
    """Arm-executed place: transport the attached object along
    ``qs[:n_move]`` (RRT to pre-place + Cartesian insertion descent), then
    hold the arm at the final config, open the fingers, and let the object
    drop under gravity.  The object stays attached until the fingers have
    opened clear of it; once released, the gripper stops being a collider.

    The fixture must be a body in ``state`` (huge mass) so insertion contact
    is simulated.  Returns (final_state, ob_pose_final (4, 4), trajectory of
    the target: (pos, quat, linvel, angvel), each (T, ...))."""
    dt = engine.DT
    dev = qs.device
    T = qs.shape[0]
    G, G_next, (ac, ah, aq, av) = _schedule(qs, base_in_world, ee_in_grasp, dt)
    ride = _ride(G, G_next, ob_in_grasp, dt)
    width = torch.zeros((), device=dev) + width
    center = torch.zeros((), device=dev) + center
    w_release = torch.clamp(width + 2.0 * spec.max_squeeze_pen + 0.002, max=spec.max_width)
    zero = torch.zeros((), device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)
    st, w = state, width
    traj = []
    for i in range(T):
        moving = i < n_move
        dv = 0.0 if moving else spec.close_speed * dt  # open after the move
        w = torch.clamp(w + dv, max=spec.max_width)
        attached = always if moving else w < w_release
        # both fingers retract outward from the hold midline at half the
        # opening rate each
        v = zero - dv / (2 * dt)
        genv = gripper_env(G[i], w, center, v, v, spec)
        genv = genv.replace(enabled=genv.enabled & attached)
        merged = merge_envs(env_bin, genv, _arm_env_of(ac[i], ah[i], aq[i], av[i]))
        st = engine.step(st, params, lib, merged, dt=dt, gravity=-9.8, narrowphase=narrowphase)
        st = _attach(st, target, *(x[i] for x in ride), where=attached)
        traj.append((st.pos[target], st.quat[target], st.linvel[target], st.angvel[target]))
    ob_pose_final = tf.pose_from_qt(st.quat[target], st.pos[target])
    return st, ob_pose_final, tuple(torch.stack(x) for x in zip(*traj))
