"""Parallel-jaw gripper in the scene and grasp scoring by physics
(``catgrasp_tpu/sim/env_grasp.py``).

The gripper lives in the GRASP frame: +x approach, ±y closing.  Ported: the
geometry the grasp filter needs, the gripper as kinematic colliders, the
per-finger force-limited closing law the executors step, the contact and
collision tests of the eval's scoring, and the grasp DB's scorer: the
close-and-shake rollout (``grasp_rollout``, ``verify_grasp``) and the
perturbation-robustness score (``perturbation_scores``).

Every quantity of the closing law stays a tensor (``torch.where`` in place
of branches), so a caller that steps it once per engine step never waits
for the device; only the phase (closing or not) is a Python bool.  Its
inputs may carry leading axes: a rollout batch steps G x trials scenes, each
with its own gripper, through one engine step, where JAX ``vmap``s them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import transforms as tf
from ..device import constant
from . import engine
from .types import SceneParams, SceneState, ShapeLib

N_CLOSE_STEPS = 50
N_SHAKE_STEPS = 50
SUCCESS_DISP = 0.02  # meters the object may move during the shake
SHAKE_GRAVITY = -10.0


@dataclass(frozen=True)
class GripperSpec:
    """Parallel-jaw geometry in the grasp frame (static hyperparams)."""

    max_width: float = 0.05
    finger_len: float = 0.045
    finger_thickness: float = 0.012
    finger_depth: float = 0.02
    palm_depth: float = 0.03
    max_force: float = 100.0
    close_speed: float = 0.3  # m/s of opening decrease
    max_squeeze_pen: float = 0.002

    @property
    def hand_depth(self):
        return self.finger_len

    @property
    def init_bite(self):
        return -0.005


def closing_channel_mask(pts_g, spec: GripperSpec, y_slack: float = 1e-3):
    """Points (..., 3) (in the GRASP frame) inside the channel the fingers close
    through: |y| within the jaw opening, |z| within the finger depth, x
    between the palm bound (``init_bite``) and the fingertip plane.  Works on
    numpy arrays and tensors alike (elementwise ops only)."""
    return ((abs(pts_g[..., 1]) <= spec.max_width / 2 + y_slack)
            & (abs(pts_g[..., 2]) <= spec.finger_depth / 2)
            & (pts_g[..., 0] <= spec.finger_len)
            & (pts_g[..., 0] >= spec.init_bite))


def finger_boxes(width: torch.Tensor, spec: GripperSpec, center=0.0):
    """Centers/halves (grasp frame) of [finger+, finger-, palm] boxes for a
    given opening ``width`` whose midline sits at y=``center``.  The palm is
    rigid on the wrist and does not ride the finger midline."""
    width = torch.as_tensor(width, dtype=torch.float32)
    t = spec.finger_thickness
    center = torch.zeros_like(width) + center
    cy_pos = center + width / 2 + t / 2
    cy_neg = center - (width / 2 + t / 2)
    zero = torch.zeros_like(width)
    centers = torch.stack(
        [
            torch.stack([torch.full_like(width, spec.finger_len / 2), cy_pos, zero], -1),
            torch.stack([torch.full_like(width, spec.finger_len / 2), cy_neg, zero], -1),
            torch.stack([torch.full_like(width, -spec.palm_depth / 2), zero, zero], -1),
        ],
        dim=-2,
    )  # (..., 3 boxes, 3)
    halves = constant(
        (
            (spec.finger_len / 2, t / 2, spec.finger_depth / 2),
            (spec.finger_len / 2, t / 2, spec.finger_depth / 2),
            (spec.palm_depth / 2, spec.max_width / 2 + t + 0.01, spec.finger_depth / 2 + 0.01),
        ),
        torch.float32, width.device,
    )
    return centers, halves.expand(centers.shape)


def _per_scene(x):
    """A per-scene quantity, a tensor (...) or a number, against each scene's
    vectors or boxes: (..., 1)."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def gripper_env(T_grasp: torch.Tensor, width: torch.Tensor, center, vel_pos, vel_neg,
                spec: GripperSpec, friction: float = 0.9, dt: float = engine.DT,
                grip=False) -> engine.StaticEnv:
    """Gripper as 3 kinematic world-frame boxes (finger+, finger-, palm).

    ``T_grasp`` is (..., 4, 4) and ``width``, ``center``, ``vel_pos``,
    ``vel_neg`` and ``grip`` broadcast against its leading axes, which the
    env then carries: one gripper a scene of a rollout batch.
    ``vel_pos``/``vel_neg`` are the INWARD speeds of the +y / -y fingers
    (positive = closing); the fingers are independent position-controlled
    motors.  Each collider may deliver at most ``max_force * dt`` of normal
    impulse a step; holding fingers (``grip``) get motor-backed static
    friction, the palm never grips."""
    dev = T_grasp.device
    centers_g, halves = finger_boxes(width, spec, center)
    R = T_grasp[..., :3, :3]
    centers_w = centers_g @ R.transpose(-1, -2) + T_grasp[..., None, :3, 3]
    lead = centers_w.shape[:-2]
    quats = tf.matrix_to_quat(R)[..., None, :].expand(*lead, 3, 4)
    # closing velocity: finger+ moves -y_grasp, finger- moves +y_grasp
    ydir = R[..., :, 1]
    vel = torch.stack([-ydir * _per_scene(vel_pos), ydir * _per_scene(vel_neg),
                       torch.zeros_like(ydir)], dim=-2)
    grip = constant((True, True, False), torch.bool, dev) & _per_scene(grip)
    return engine.StaticEnv(
        center=centers_w,
        half=halves.expand(centers_w.shape),
        quat=quats,
        vel=vel,
        friction=torch.full((*lead, 3), friction, device=dev),
        enabled=torch.ones((*lead, 3), dtype=torch.bool, device=dev),
        imp_budget=torch.full((*lead, 3), spec.max_force * dt, device=dev),
        grip=grip.expand(*lead, 3),
    )


def _object_pen_per_finger(obj_pts_grasp: torch.Tensor, width, spec: GripperSpec,
                           center=0.0):
    """Per-finger SIGNED penetration along the closing axis of the extremal
    in-channel object point past each finger's inner face (negative =
    clearance): ``(pen_pos, pen_neg)``, -1e3 each when no point is in the
    channel.  Points are (..., P, 3), ``width`` and ``center`` (...)."""
    in_ch = closing_channel_mask(obj_pts_grasp, spec)
    y = obj_pts_grasp[..., 1]
    f_pos = torch.as_tensor(center + width / 2)[..., None]
    f_neg = torch.as_tensor(center - width / 2)[..., None]
    pen_p = torch.amax(torch.where(in_ch, y - f_pos, float("-inf")), dim=-1)
    pen_n = torch.amax(torch.where(in_ch, f_neg - y, float("-inf")), dim=-1)
    any_ch = torch.any(in_ch, dim=-1)
    return torch.where(any_ch, pen_p, -1e3), torch.where(any_ch, pen_n, -1e3)


# first-contact latch threshold: just above the Baumgarte resting
# penetration (engine.SLOP = 0.2 mm)
CONTACT_TOL = 2.5e-4
# touch-down speed (m/s): a free finger brakes near the object face and
# creeps into contact at this speed
LAND_SPEED = 0.02
# squeeze speed (m/s): once both fingers have touched, penetration is driven
# to max_squeeze_pen at this bounded speed
SQUEEZE_SPEED = 0.05
# grip press (m/s^2) of the holding finger motors during hold and transport
PRESS_ACCEL = 100.0


def closing_touched_init(device=None, shape=()) -> torch.Tensor:
    """Initial per-finger first-contact latch: (*shape, 2) bool,
    [touched_pos, touched_neg]."""
    return torch.zeros((*shape, 2), dtype=torch.bool, device=device)


def closing_step(obj_pts_grasp: torch.Tensor, width: torch.Tensor, center: torch.Tensor,
                 touched: torch.Tensor, closing: bool, spec: GripperSpec, dt: float):
    """One tick of the force-limited closing law.

    Each finger is an independent position-controlled motor with a sticky
    first-contact latch (``touched``) and three regimes: free (never
    touched: land at the object face, at most ``close_speed/2`` a second,
    creeping the last of it at ``LAND_SPEED``), wall (touched, the other
    free: hold, yield beyond ``max_squeeze_pen``) and squeeze (both touched:
    drive own penetration to ``max_squeeze_pen`` at ``SQUEEZE_SPEED``).  The
    width is floored at the in-channel object extent less the two-sided
    allowance.  The latch updates every tick; the fingers move only while
    ``closing``.  Points are (..., P, 3); ``width``, ``center`` (...) and
    ``touched`` (..., 2) carry the same leading axes.

    Returns ``(new_width, new_center, new_touched, v_pos, v_neg)``, v_* the
    fingers' inward speeds for :func:`gripper_env`."""
    pen_p, pen_n = _object_pen_per_finger(obj_pts_grasp, width, spec, center)
    touched = touched | torch.stack([pen_p > CONTACT_TOL, pen_n > CONTACT_TOL], dim=-1)
    if not closing:
        zero = torch.zeros_like(width)
        return width, center, touched, zero, zero
    both = touched[..., 0] & touched[..., 1]
    half_step = spec.close_speed * dt / 2
    creep = LAND_SPEED * dt
    sq_step = SQUEEZE_SPEED * dt

    def advance(own_touched, own_pen):
        free = torch.clamp(torch.clamp(-0.5 * own_pen, min=creep), max=half_step)
        err = spec.max_squeeze_pen - own_pen
        squeeze = torch.where(
            err >= 0,
            torch.clamp(err + creep, max=min(sq_step, half_step)),
            -torch.clamp(-err, max=sq_step / 2))
        wall = -torch.clamp(torch.clamp(-err, min=0.0), max=sq_step / 2)
        return torch.where(~own_touched, free, torch.where(both, squeeze, wall))

    df_p = advance(touched[..., 0], pen_p)
    df_n = advance(touched[..., 1], pen_n)
    # width floor: object channel extent minus the two-sided allowance (0
    # when nothing is in the channel)
    in_ch = closing_channel_mask(obj_pts_grasp, spec)
    y = obj_pts_grasp[..., 1]
    ymax = torch.amax(torch.where(in_ch, y, float("-inf")), dim=-1)
    ymin = torch.amin(torch.where(in_ch, y, float("inf")), dim=-1)
    extent = torch.where(torch.any(in_ch, dim=-1), ymax - ymin, 0.0)
    min_width = torch.clamp(extent - 2.0 * spec.max_squeeze_pen, min=0.0)
    # shrink the ADVANCES (retreats untouched) so that width_new >= min_width
    cap_total = torch.clamp(width - min_width, min=0.0)
    total = df_p + df_n
    adv = torch.clamp(df_p, min=0.0) + torch.clamp(df_n, min=0.0)
    excess = torch.clamp(total - cap_total, min=0.0)
    shrink = torch.clamp(1.0 - excess / torch.clamp(adv, min=1e-9), min=0.0)
    df_p = torch.where(df_p > 0, df_p * shrink, df_p)
    df_n = torch.where(df_n > 0, df_n * shrink, df_n)
    return (width - df_p - df_n, center - (df_p - df_n) / 2, touched,
            df_p / dt, df_n / dt)


def open_gripper_collision(obj_pts_grasp: torch.Tensor, spec: GripperSpec) -> torch.Tensor:
    """Open-gripper collision test: any object point (..., C, 3) inside any
    gripper box at full opening; (...) bool."""
    dev = obj_pts_grasp.device
    centers, halves = finger_boxes(torch.full((), spec.max_width, device=dev), spec)
    rel = obj_pts_grasp[..., :, None, :] - centers
    d, _ = engine.box_sdf_and_normal(rel, halves)
    return torch.any(d < 0.0, dim=(-2, -1))


def grasp_rollout_start(lib: ShapeLib, shape_id, scale, grasp_in_ob: torch.Tensor,
                        spec: GripperSpec = GripperSpec(), friction: float = 0.7):
    """The scenes of a batch of grasp rollouts before the first step: the
    object at identity, one scene a pose of ``grasp_in_ob`` (..., 4, 4), the
    gripper open.  Returns ``(params, carry, collided)``: the scene batch's
    parameters, ``(state, width, center, touched)`` and the open-gripper
    collision flag (...)."""
    dev = grasp_in_ob.device
    lead = grasp_in_ob.shape[:-2]
    one = SceneParams.create(lib, torch.as_tensor(shape_id, device=dev).reshape(1),
                             torch.as_tensor(scale, device=dev).reshape(1), friction=friction)
    params = SceneParams(**{k: v.expand(*lead, *v.shape) for k, v in vars(one).items()})
    quat = torch.zeros((*lead, 1, 4), device=dev)
    quat[..., 0] = 1.0
    state = SceneState(pos=torch.zeros((*lead, 1, 3), device=dev), quat=quat,
                       linvel=torch.zeros((*lead, 1, 3), device=dev),
                       angvel=torch.zeros((*lead, 1, 3), device=dev),
                       active=torch.ones((*lead, 1), dtype=torch.bool, device=dev))
    pts0 = tf.transform_points(tf.pose_inverse(grasp_in_ob), _object_points(lib, params))
    collided = open_gripper_collision(pts0, spec)
    width = torch.full(lead, spec.max_width, device=dev)
    carry = (state, width, torch.zeros(lead, device=dev), closing_touched_init(dev, lead))
    return params, carry, collided


def _object_points(lib: ShapeLib, params: SceneParams) -> torch.Tensor:
    """Each scene's object surface sample points in the object's frame:
    (..., P, 3)."""
    return lib.surf_pts[params.shape_id[..., 0]] * params.scale[..., 0, None, None]


def grasp_rollout_steps(lib: ShapeLib, params: SceneParams, grasp_in_ob: torch.Tensor, carry,
                        steps: range, n_close: int, spec: GripperSpec = GripperSpec(),
                        narrowphase: str = "csg", dt: float = engine.DT,
                        n_iter: int = engine.N_ITER):
    """Engine steps ``steps`` of a rollout batch from ``carry``: the fingers
    close by the closing law while the step index is below ``n_close``,
    then hold under ``SHAKE_GRAVITY``.  Returns the new carry."""
    T_inv = tf.pose_inverse(grasp_in_ob)
    surf = _object_points(lib, params)
    st, w, c, tch = carry
    for i in steps:
        closing = i < n_close
        R = tf.quat_to_matrix(st.quat[..., 0, :])
        pts_g = tf.transform_points(T_inv, st.pos[..., 0, None, :] + surf @ R.transpose(-1, -2))
        w, c, tch, v_p, v_n = closing_step(pts_g, w, c, tch, closing, spec, dt)
        env = gripper_env(grasp_in_ob, w, c, v_p, v_n, spec, dt=dt,
                          grip=False if closing else tch[..., 0] & tch[..., 1])
        st = engine.step(st, params, lib, env, dt=dt, gravity=0.0 if closing else SHAKE_GRAVITY,
                         n_iter=n_iter, narrowphase=narrowphase)
    return st, w, c, tch


def grasp_rollout(lib: ShapeLib, shape_id, scale, grasp_in_ob: torch.Tensor,
                  spec: GripperSpec = GripperSpec(), friction: float = 0.7,
                  narrowphase: str = "csg", dt: float = engine.DT,
                  n_iter: int = engine.N_ITER) -> dict:
    """Close-then-shake rollout of a gripper at each pose of ``grasp_in_ob``
    (..., 4, 4) on the object at identity, all poses one scene batch:
    ``N_CLOSE_STEPS`` closing steps, then ``N_SHAKE_STEPS`` under
    ``SHAKE_GRAVITY``, both rescaled to ``dt`` so their durations stay put.
    Returns a dict of (...) tensors: ``success`` (no open-gripper collision
    and the object moved at most ``SUCCESS_DISP``), ``collided``, the final
    ``width`` and finger-midline ``center``, the object's pose after the
    close and at the end, and its ``displacement``.  Object friction 0.7 is
    the grasp-scoring setup; the gripper keeps :func:`gripper_env`'s 0.9."""
    n_close = int(round(N_CLOSE_STEPS * engine.DT / dt))
    n_shake = int(round(N_SHAKE_STEPS * engine.DT / dt))
    params, carry, collided = grasp_rollout_start(lib, shape_id, scale, grasp_in_ob, spec,
                                                  friction)
    run = dict(n_close=n_close, spec=spec, narrowphase=narrowphase, dt=dt, n_iter=n_iter)
    carry = grasp_rollout_steps(lib, params, grasp_in_ob, carry, range(n_close), **run)
    post_close = carry[0]
    final, w_final, c_final, _ = grasp_rollout_steps(
        lib, params, grasp_in_ob, carry, range(n_close, n_close + n_shake), **run)
    disp = tf.norm(final.pos[..., 0, :])
    return {
        "success": ~collided & (disp <= SUCCESS_DISP),
        "collided": collided,
        "width": w_final,
        "center": c_final,
        "ob_pose_final": tf.pose_from_qt(final.quat[..., 0, :], final.pos[..., 0, :]),
        "ob_pose_close": tf.pose_from_qt(post_close.quat[..., 0, :], post_close.pos[..., 0, :]),
        "displacement": disp,
    }


def verify_grasp(lib: ShapeLib, shape_id, scale, grasp_in_ob: torch.Tensor,
                 spec: GripperSpec = GripperSpec(), friction: float = 0.7,
                 narrowphase: str = "csg", dt: float = engine.DT,
                 n_iter: int = engine.N_ITER) -> torch.Tensor:
    """Success (...) bool of the close-and-shake test of each grasp pose
    (..., 4, 4), the object at identity; a batch of poses is one scene
    batch."""
    return grasp_rollout(lib, shape_id, scale, grasp_in_ob, spec, friction, narrowphase,
                         dt=dt, n_iter=n_iter)["success"]


# ``verify_grasp`` broadcasts over leading axes, so a batch is the same call
verify_grasp_batch = verify_grasp


def perturbation_scores(generator: torch.Generator, lib: ShapeLib, shape_id, scale,
                        grasp_poses: torch.Tensor, trials: int = 50,
                        spec: GripperSpec = GripperSpec(), friction: float = 0.7,
                        narrowphase: str = "csg", dt: float = engine.DT,
                        n_iter: int = engine.N_ITER) -> torch.Tensor:
    """Perturbation-robustness score per grasp: (G, 4, 4) -> (G,) in [0, 1],
    the success fraction of ``trials`` random perturbations of each grasp
    (uniform up to 5 mm and 10 degrees, drawn from ``generator``).  All G x
    ``trials`` rollouts step as one scene batch."""
    G = grasp_poses.shape[0]
    offsets = tf.random_uniform_magnitude(generator, max_t=0.005, max_r_deg=10.0,
                                          shape=(G, trials))
    perturbed = torch.einsum("gij,gtjk->gtik", grasp_poses, offsets.to(grasp_poses.device))
    succ = verify_grasp(lib, shape_id, scale, perturbed, spec, friction, narrowphase,
                        dt=dt, n_iter=n_iter)
    return torch.mean(succ.to(torch.float32), dim=-1)


def finger_contact_points(obj_pts_grasp: torch.Tensor, width, spec: GripperSpec,
                          surface_tol: float = 0.002, center=0.0):
    """Masks of object points (grasp frame, (..., C, 3)) in contact with the
    +y and the -y finger's inner face: (mask_pos, mask_neg), (..., C)."""
    x, y, z = obj_pts_grasp[..., 0], obj_pts_grasp[..., 1], obj_pts_grasp[..., 2]
    within = (x >= 0.0) & (x <= spec.finger_len) & (torch.abs(z) <= spec.finger_depth / 2)
    near_pos = torch.abs(y - (center + width / 2)) <= surface_tol
    near_neg = torch.abs(y - (center - width / 2)) <= surface_tol
    return within & near_pos, within & near_neg
