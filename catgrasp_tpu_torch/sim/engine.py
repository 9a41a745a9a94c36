"""Rigid-body contact engine (``catgrasp_tpu/sim/engine.py`` in PyTorch).

``step(state, params, lib, env) -> state`` with static shapes.  The state
and parameters are one scene, (N, ...), or a batch of scenes with leading
axes, (B, N, ...): every function here broadcasts over them, the library and
the env boxes are shared, and ``rollout_batch`` is the counterpart of the JAX
package's ``vmap(engine.rollout)``.  Per scene:

* **Narrowphase = SDF queries.** Every body carries P surface sample points;
  a contact candidate is (point of body i, collider m).  Colliders are the
  other bodies (analytic CSG, scaled; or, with ``narrowphase="grid"``, their
  baked SDF grids, scaled) and a set of analytic boxes (bin walls, floor,
  kinematic gripper fingers).  Candidates form a dense
  (..., N, P, M) tensor; reaction forces on body j are a transpose-sum.
* **Velocity-level Jacobi impulse solver** with split impulse, exact
  tangential effective mass, a friction passivity guard and motor-backed
  grip friction.
* **Semi-implicit Euler** at PyBullet's default dt=1/240 s.

The grid narrowphase is the arbitrary-mesh path: a trilinear lookup with its
analytic gradient in each collider's grid, plain PyTorch on the device, as
the JAX package computes it in XLA (``geom/sdf.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core import transforms as tf
from ..device import constant, resolve_device
from ..geom import csg as csglib
from ..geom import sdf as sdflib
from .types import SceneParams, SceneState, ShapeLib

DT = 1.0 / 240.0
BAUMGARTE = 0.2
SLOP = 2e-4
N_ITER = 4
# Friction passivity guard: each Jacobi iteration scales every body's summed
# friction delta by the largest alpha in [0,1] for which its kinetic energy
# does not increase (the energy change is a quadratic in alpha).
FRICTION_RELAX = 0.5
# bodies at/above this mass are static fixtures: they collide but receive no
# gravity and never move
STATIC_MASS = 1e8


@dataclass
class StaticEnv:
    """Analytic box colliders (bin, floor, gripper fingers).  Kinematic:
    infinite mass, optional linear velocity (for moving fingers)."""

    center: torch.Tensor  # (M, 3)
    half: torch.Tensor  # (M, 3)
    quat: torch.Tensor  # (M, 4)
    vel: torch.Tensor  # (M, 3)
    friction: torch.Tensor  # (M,)
    enabled: torch.Tensor  # (M,) bool
    # per-step normal-impulse budget (N·s) each collider may deliver across
    # all its contacts (finger motor force limit); inf = unbounded
    imp_budget: torch.Tensor  # (M,)
    # gripping collider: static-friction cap backed by the motor budget
    grip: torch.Tensor  # (M,) bool

    def replace(self, **kw) -> "StaticEnv":
        return replace(self, **kw)

    @staticmethod
    def boxes(centers, halves, quats=None, friction=0.7, imp_budget=None,
              device=None) -> "StaticEnv":
        dev = resolve_device(device)
        centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
        m = centers.shape[0]
        halves = torch.as_tensor(halves, dtype=torch.float32, device=dev)
        if quats is None:
            quats = torch.zeros((m, 4), device=dev)
            quats[:, 0] = 1.0
        if imp_budget is None:
            imp_budget = torch.full((m,), float("inf"), device=dev)
        return StaticEnv(
            center=centers,
            half=halves,
            quat=torch.as_tensor(quats, dtype=torch.float32, device=dev),
            vel=torch.zeros((m, 3), device=dev),
            friction=torch.full((m,), friction, device=dev),
            enabled=torch.ones((m,), dtype=torch.bool, device=dev),
            imp_budget=torch.as_tensor(imp_budget, dtype=torch.float32, device=dev),
            grip=torch.zeros((m,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def open_bin(inner=(0.3, 0.3, 0.12), wall=0.01, friction=0.7,
                 device=None) -> "StaticEnv":
        """Floor + 4 walls forming an open-top bin, interior floor at z=0
        centered at origin."""
        ix, iy, iz = inner
        centers = [
            (0, 0, -wall / 2),
            (ix / 2 + wall / 2, 0, iz / 2),
            (-ix / 2 - wall / 2, 0, iz / 2),
            (0, iy / 2 + wall / 2, iz / 2),
            (0, -iy / 2 - wall / 2, iz / 2),
        ]
        halves = [
            (ix / 2 + wall, iy / 2 + wall, wall / 2),
            (wall / 2, iy / 2 + wall, iz / 2),
            (wall / 2, iy / 2 + wall, iz / 2),
            (ix / 2, wall / 2, iz / 2),
            (ix / 2, wall / 2, iz / 2),
        ]
        return StaticEnv.boxes(centers, halves, friction=friction, device=device)


def box_sdf_and_normal(p_local: torch.Tensor, half: torch.Tensor):
    """Analytic box SDF + outward normal for local points (..., 3)."""
    q = torch.abs(p_local) - half
    outside_vec = torch.clamp(q, min=0.0)
    d_out = torch.sqrt(torch.sum(outside_vec * outside_vec, dim=-1))
    d_in = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    d = d_out + d_in
    n_out = outside_vec * torch.sign(p_local)
    qmax = torch.amax(q, dim=-1, keepdim=True)
    oh = (q >= qmax).to(p_local.dtype)
    oh = oh / torch.sum(oh, dim=-1, keepdim=True)
    n_in = oh * torch.sign(p_local)
    n = torch.where((d_out > 0)[..., None], n_out, n_in)
    return d, n / (torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)) + 1e-12)


def _body_surface_points(state: SceneState, params: SceneParams, lib: ShapeLib):
    """World-frame surface sample points of every body: (..., N, P, 3)."""
    pts_local = lib.surf_pts[params.shape_id] * params.scale[..., None, None]
    R = tf.quat_to_matrix(state.quat)
    return torch.einsum("...nij,...npj->...npi", R, pts_local) + state.pos[..., None, :]


def _sdf_vs_bodies(w_pts, state, params, lib):
    """φ and world normal of every point vs every body: (...,N,P,NB), (...,N,P,NB,3)."""
    R = tf.quat_to_matrix(state.quat)
    rel = w_pts[..., None, :] - state.pos[..., None, None, :, :]
    loc = torch.einsum("...bji,...npbj->...npbi", R, rel) \
        / params.scale[..., None, None, :, None]
    # one shape per collider body: (..., 1, 1, NB, S[, 3]) against the points
    shape = csglib.select_shape(lib.csg, params.shape_id[..., None, None, :])
    phi, n_loc = csglib.csg_sdf_and_normal(shape, loc)
    phi = phi * params.scale[..., None, None, :]
    n_world = torch.einsum("...bij,...npbj->...npbi", R, n_loc)
    return phi, n_world


def _sdf_vs_bodies_grid(w_pts, state, params, lib):
    """:func:`_sdf_vs_bodies` through each collider body's baked SDF grid
    (``lib.sdf_values``, from ``build_shape_lib(bake_grids=True)``): one
    8-corner fetch a (point, body) pair gives φ and the normal."""
    if lib.sdf_values is None:
        raise ValueError("narrowphase='grid' needs a library built with bake_grids=True")
    R = tf.quat_to_matrix(state.quat)
    rel = w_pts[..., None, :] - state.pos[..., None, None, :, :]
    loc = torch.einsum("...bji,...npbj->...npbi", R, rel) \
        / params.scale[..., None, None, :, None]
    phi, n_loc = sdflib.query_and_grad_shapes(lib.sdf_values, lib.sdf_lower, lib.sdf_spacing,
                                              params.shape_id[..., None, None, :], loc)
    phi = phi * params.scale[..., None, None, :]
    n_world = torch.einsum("...bij,...npbj->...npbi", R, n_loc)
    return phi, n_world


_BODY_SDF = {"csg": _sdf_vs_bodies, "grid": _sdf_vs_bodies_grid}


def _sdf_vs_env(w_pts, env: StaticEnv):
    """φ and world normal of every point vs every env box: (...,N,P,M), (...,N,P,M,3)."""
    Rm = tf.quat_to_matrix(env.quat)
    rel = w_pts[..., None, :] - env.center
    loc = torch.einsum("mji,...npmj->...npmi", Rm, rel)
    d, n_loc = box_sdf_and_normal(loc, env.half)
    n_world = torch.einsum("mij,...npmj->...npmi", Rm, n_loc)
    d = torch.where(env.enabled, d, 1e9)
    return d, n_world


def _solve_contacts(state: SceneState, params: SceneParams, lib: ShapeLib,
                    env: StaticEnv, dt: float, n_iter: int, narrowphase: str = "csg"):
    """Jacobi impulse iteration; returns new (linvel, angvel, plin, pang)."""
    N = state.pos.shape[-2]
    batch = state.pos.shape[:-2]
    dev = state.pos.device
    w_pts = _body_surface_points(state, params, lib)  # (...,N,P,3)
    P = w_pts.shape[-2]

    phi_b, n_b = _BODY_SDF[narrowphase](w_pts, state, params, lib)  # (...,N,P,N[,3])
    phi_e, n_e = _sdf_vs_env(w_pts, env)  # (...,N,P,M[,3])

    active = state.active
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    pair_ok = active[..., :, None] & active[..., None, :] & ~eye
    phi_b = torch.where(pair_ok[..., :, None, :], phi_b, 1e9)
    phi_e = torch.where(active[..., None, None], phi_e, 1e9)

    phi = torch.cat([phi_b, phi_e], dim=-1)  # (...,N,P,M_tot)
    nrm = torch.cat([n_b, n_e], dim=-2)  # (...,N,P,M_tot,3)
    M_tot = phi.shape[-1]
    M_env = M_tot - N

    pen = torch.clamp(-phi, min=0.0)
    in_contact = pen > 0.0

    dyn = active & (params.mass < STATIC_MASS)
    inv_mass = torch.where(dyn, 1.0 / params.mass, 0.0)
    inv_inertia = torch.where(dyn[..., None], 1.0 / params.inertia, 0.0)
    R = tf.quat_to_matrix(state.quat)
    inv_I_world = torch.einsum("...nij,...nj,...nkj->...nik", R, inv_inertia, R)
    I_world = torch.einsum("...nij,...nj,...nkj->...nik", R, params.inertia, R)

    r_i = (w_pts[..., None, :] - state.pos[..., :, None, None, :]).expand(
        *batch, N, P, M_tot, 3)
    r_j_b = w_pts[..., None, :] - state.pos[..., None, None, :, :]  # (...,N,P,NB,3)

    zeros_env = torch.zeros((*batch, N, P, M_env), device=dev)
    rixn = tf.cross(r_i, nrm)
    term_i = torch.einsum("...npmk,...nkl,...npml->...npm", rixn, inv_I_world, rixn)
    inv_mass_j = torch.cat([inv_mass, torch.zeros((*batch, M_env), device=dev)], dim=-1)
    rjxn = tf.cross(r_j_b, n_b)
    term_j_b = torch.einsum("...npbk,...bkl,...npbl->...npb", rjxn, inv_I_world, rjxn)
    term_j = torch.cat([term_j_b, zeros_env], dim=-1)
    K_n = inv_mass[..., :, None, None] + inv_mass_j[..., None, None, :] + term_i + term_j
    K_n = torch.clamp(K_n, min=1e-9)

    mu_j = torch.cat([params.friction, env.friction.expand(*batch, M_env)], dim=-1)
    # PyBullet combines lateral friction by multiplication
    mu = params.friction[..., :, None, None] * mu_j[..., None, None, :]

    bias = BAUMGARTE / dt * torch.clamp(pen - SLOP, min=0.0)

    cnt_i = torch.sum(in_contact, dim=(-2, -1))
    cnt_j = torch.sum(in_contact[..., :N], dim=(-3, -2))
    denom = torch.clamp(cnt_i + cnt_j, min=1).to(torch.float32)

    cnt_m = torch.sum(in_contact, dim=(-3, -2)).to(torch.float32)
    grip_j = torch.cat([torch.zeros(N, dtype=torch.bool, device=dev), env.grip])
    budget_j = torch.cat([torch.full((N,), float("inf"), device=dev), env.imp_budget])
    jt_grip_cap = torch.where(
        grip_j, (budget_j / n_iter) / torch.clamp(cnt_m, min=1.0), 0.0)

    env_vel = env.vel  # (M_env,3) velocity of each env collider
    scale = 1.0 / denom  # Jacobi averaging per body

    def deltas(impulse):
        dlin_i = torch.sum(impulse, dim=(-3, -2)) * inv_mass[..., None] * scale[..., None]
        dang_i = torch.einsum("...nij,...npmj->...ni", inv_I_world,
                              tf.cross(r_i, impulse)) * scale[..., None]
        imp_on_j = -impulse[..., :N, :]  # reaction on body colliders
        dlin_j = torch.sum(imp_on_j, dim=(-4, -3)) * inv_mass[..., None] * scale[..., None]
        dang_j = torch.einsum("...bij,...npbj->...bi", inv_I_world,
                              tf.cross(r_j_b, imp_on_j)) * scale[..., None]
        return dlin_i + dlin_j, dang_i + dang_j

    linvel, angvel = state.linvel, state.angvel
    plin = torch.zeros_like(linvel)
    pang = torch.zeros_like(angvel)
    for _ in range(n_iter):
        v_pt_i = linvel[..., :, None, None, :] + tf.cross(angvel[..., :, None, None, :], r_i)
        v_pt_j_b = linvel[..., None, None, :, :] \
            + tf.cross(angvel[..., None, None, :, :], r_j_b)
        v_pt_j = torch.cat([v_pt_j_b, env_vel.expand(*batch, N, P, M_env, 3)], dim=-2)
        v_rel = v_pt_i - v_pt_j
        v_n = torch.sum(v_rel * nrm, dim=-1)

        # split impulse: the velocity channel resolves only the real
        # approach; penetration recovery lives in the pseudo channel
        jn = (-v_n) / K_n
        jn = torch.where(in_contact, torch.clamp(jn, min=0.0), 0.0)

        # impulse-budget clamp for kinematic colliders, on the impulse
        # actually applied (after the Jacobi 1/denom averaging)
        env_tot = torch.sum(jn[..., N:] / denom[..., None, None], dim=(-3, -2))
        env_fac = torch.clamp((env.imp_budget / n_iter)
                              / torch.clamp(env_tot, min=1e-12), max=1.0)
        fac = torch.cat([torch.ones((*batch, N), device=dev), env_fac], dim=-1)
        jn = jn * fac[..., None, None, :]

        v_t = v_rel - v_n[..., None] * nrm
        vt_norm = torch.sqrt(torch.sum(v_t * v_t, dim=-1))
        t_dir = v_t / (vt_norm[..., None] + 1e-9)
        # exact tangential effective mass, recomputed per iteration
        rixt = tf.cross(r_i, t_dir)
        term_i_t = torch.einsum("...npmk,...nkl,...npml->...npm", rixt, inv_I_world, rixt)
        rjxt = tf.cross(r_j_b, t_dir[..., :N, :])
        term_j_t_b = torch.einsum("...npbk,...bkl,...npbl->...npb", rjxt, inv_I_world, rjxt)
        term_j_t = torch.cat([term_j_t_b, zeros_env], dim=-1)
        K_t = inv_mass[..., :, None, None] + inv_mass_j[..., None, None, :] \
            + term_i_t + term_j_t
        K_t = torch.clamp(K_t, min=1e-9)
        jt_mag = FRICTION_RELAX * vt_norm / K_t
        jt_cap = mu * torch.maximum(jn, jt_grip_cap[..., None, None, :])
        jt_mag = torch.minimum(jt_mag, jt_cap)
        jt = -jt_mag[..., None] * t_dir

        imp_n = jn[..., None] * nrm  # normal impulse ON body i

        # pseudo channel: normal-only, Baumgarte bias against the current
        # pseudo velocities (env colliders carry none)
        p_pt_i = plin[..., :, None, None, :] + tf.cross(pang[..., :, None, None, :], r_i)
        p_pt_j_b = plin[..., None, None, :, :] + tf.cross(pang[..., None, None, :, :], r_j_b)
        p_pt_j = torch.cat([p_pt_j_b, torch.zeros((*batch, N, P, M_env, 3), device=dev)],
                           dim=-2)
        p_n = torch.sum((p_pt_i - p_pt_j) * nrm, dim=-1)
        jp = (-p_n + bias) / K_n
        jp = torch.where(in_contact, torch.clamp(jp, min=0.0), 0.0)
        imp_p = jp[..., None] * nrm

        dlin_n, dang_n = deltas(imp_n)
        linvel = linvel + dlin_n
        angvel = angvel + dang_n

        # friction passivity guard: dKE(alpha) = alpha*B + alpha^2*C
        dlin_f, dang_f = deltas(jt)
        Iw_dang = torch.einsum("...nij,...nj->...ni", I_world, dang_f)
        B = params.mass * torch.sum(linvel * dlin_f, dim=-1) \
            + torch.sum(torch.einsum("...nij,...nj->...ni", I_world, angvel) * dang_f, dim=-1)
        C = 0.5 * (params.mass * torch.sum(dlin_f * dlin_f, dim=-1)
                   + torch.sum(dang_f * Iw_dang, dim=-1))
        alpha = torch.where(B + C <= 0.0, 1.0,
                            torch.clamp(-B / torch.clamp(C, min=1e-20), 0.0, 1.0))
        linvel = linvel + alpha[..., None] * dlin_f
        angvel = angvel + alpha[..., None] * dang_f

        dplin, dpang = deltas(imp_p)
        plin = plin + dplin
        pang = pang + dpang
    return linvel, angvel, plin, pang


def step(state: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv,
         dt: float = DT, gravity: float = -9.8, n_iter: int = N_ITER,
         linear_damping: float = 0.0095, angular_damping: float = 0.0095,
         narrowphase: str = "csg") -> SceneState:
    """One physics step of one scene or of a scene batch.  Damping is given
    PER 1/240 s step (PyBullet's per-second 0.9 at 240 Hz) and rescaled to
    the actual dt.  ``narrowphase`` is "csg" (analytic trees) or "grid"
    (baked SDF grids)."""
    if narrowphase not in _BODY_SDF:
        raise ValueError(f"narrowphase must be one of {sorted(_BODY_SDF)}, got {narrowphase!r}")
    dev = state.pos.device
    g = constant((0.0, 0.0, gravity), torch.float32, dev)
    dynamic = state.active & (params.mass < STATIC_MASS)
    linvel = state.linvel + torch.where(dynamic[..., None], g * dt, 0.0)
    st = state.replace(linvel=linvel)

    linvel, angvel, plin, pang = _solve_contacts(st, params, lib, env, dt, n_iter, narrowphase)
    lin_keep = (1.0 - linear_damping) ** (dt / DT)
    ang_keep = (1.0 - angular_damping) ** (dt / DT)
    linvel = linvel * lin_keep
    angvel = angvel * ang_keep
    # static bodies collide but never move
    dyn = dynamic[..., None]
    linvel = torch.where(dyn, linvel, 0.0)
    angvel = torch.where(dyn, angvel, 0.0)
    plin = torch.where(dyn, plin, 0.0)
    pang = torch.where(dyn, pang, 0.0)

    # positions integrate real + pseudo velocities; only the real ones
    # persist into the next step (split impulse)
    pos = state.pos + torch.where(dyn, (linvel + plin) * dt, 0.0)
    ang_int = angvel + pang
    dq = tf.quat_mul(torch.cat([torch.zeros_like(ang_int[..., :1]), ang_int], dim=-1),
                     state.quat)
    quat = tf.quat_normalize(state.quat + 0.5 * dt * dq)
    quat = torch.where(dyn, quat, state.quat)
    return state.replace(pos=pos, quat=quat, linvel=linvel, angvel=angvel)


def rollout(state: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv,
            n_steps: int, dt: float = DT, gravity: float = -9.8, n_iter: int = N_ITER,
            narrowphase: str = "csg") -> SceneState:
    """Step n_steps times."""
    for _ in range(n_steps):
        state = step(state, params, lib, env, dt, gravity, n_iter,
                     narrowphase=narrowphase)
    return state


def rollout_batch(states: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv,
                  n_steps: int, dt: float = DT) -> SceneState:
    """``rollout`` of a scene batch (B, N, ...) in eager PyTorch over the
    scene axis: the counterpart of ``vmap(engine.rollout)``, and the unfused
    comparison of ``ops.fused_rollout.rollout_fused``."""
    if states.pos.dim() != 3 or params.scale.dim() != 2:
        raise ValueError("rollout_batch: states and params need one leading scene axis, "
                         f"got pos {tuple(states.pos.shape)}, scale {tuple(params.scale.shape)}")
    return rollout(states, params, lib, env, n_steps, dt=dt)


def max_body_motion(prev: SceneState, cur: SceneState) -> torch.Tensor:
    """Max positional movement across a scene's active bodies — the
    stability signal of the settle loop."""
    d = torch.sqrt(torch.sum((cur.pos - prev.pos) ** 2, dim=-1))
    return torch.amax(torch.where(cur.active, d, 0.0), dim=-1)
