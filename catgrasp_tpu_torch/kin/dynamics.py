"""Articulated rigid-body dynamics of the iiwa14: joint-space RNEA
(``catgrasp_tpu/kin/dynamics.py`` in PyTorch).

Recursive Newton-Euler inverse dynamics over the 7-joint serial chain, the
mass matrix from unit-acceleration RNEA columns, and a semi-implicit-Euler
rollout under force-limited PD control (``track_schedule``).

The recursions are written over the joint axis at once: the forward pass's
angular velocities, accelerations and origin accelerations are prefix sums
of per-joint terms, and the backward pass's forces and moments suffix sums,
so an RNEA pass is a few dozen tensor operations whatever the batch.  Every
function broadcasts over leading axes; ``mass_matrix`` runs its 7 columns
as one batched pass, and a step of ``track_schedule`` runs the 7 columns
and both bias rows (gravity alone, and gravity with the joint velocities)
as one pass of 9 rows.  Nothing in a step reads a device value, so a
schedule is queued without the host waiting.

The chain reproduces :mod:`catgrasp_tpu_torch.kin.iiwa` exactly.  The
inertial parameters are the published KUKA LBR iiwa 14 R820 link masses
with approximate COMs and diagonal link inertias, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transforms as tf
from ..device import constant
from . import iiwa

# chain: translation (in the parent frame) to each joint origin, then the
# rotation about the joint axis.  The composite equals iiwa.fk's
# Tz(.36) Rz Ry Rz Tz(.42) Ry Tz(.40) Rz Ry Rz Tz(.126).
_TRANS = np.array([
    [0.0, 0.0, iiwa.D_BS],
    [0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0],
    [0.0, 0.0, iiwa.D_SE],
    [0.0, 0.0, iiwa.D_EW],
    [0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0],
])
_AXES = np.array([
    [0.0, 0.0, 1.0],
    [0.0, 1.0, 0.0],
    [0.0, 0.0, 1.0],
    [0.0, 1.0, 0.0],
    [0.0, 0.0, 1.0],
    [0.0, 1.0, 0.0],
    [0.0, 0.0, 1.0],
])
_FLANGE = np.array([0.0, 0.0, iiwa.D_WF])

# published iiwa14 link masses (kg); COMs placed along the chain (joint-i
# frame), diagonal inertia ~ m * r^2 with r ~ the link's envelope
MASSES = np.array([5.76, 6.35, 3.5, 3.5, 3.5, 1.8, 1.3])
_COMS = np.array([
    [0.0, -0.03, -0.12],
    [0.0, 0.04, 0.10],
    [0.0, 0.03, 0.27],
    [0.0, -0.03, 0.10],
    [0.0, -0.02, 0.22],
    [0.0, 0.0, 0.03],
    [0.0, 0.0, 0.06],
])
_INERTIA_DIAG = np.array([
    [0.033, 0.033, 0.012],
    [0.031, 0.031, 0.010],
    [0.025, 0.025, 0.008],
    [0.017, 0.017, 0.006],
    [0.010, 0.010, 0.003],
    [0.005, 0.005, 0.002],
    [0.001, 0.001, 0.001],
])
# iiwa14 rated joint torques (N*m, KUKA spec sheet)
TORQUE_LIMITS = np.array([320.0, 320.0, 176.0, 176.0, 110.0, 40.0, 40.0])
GRAVITY = np.array([0.0, 0.0, -9.81])
# the positional servo of ``pd_torque``, and the inertia-scaled servo and
# substeps a waypoint of ``track_schedule``
PD_KP, PD_KD = 600.0, 50.0
TRACK_KP, TRACK_KD, SUBSTEPS = 400.0, 36.0, 8

_Z_JOINTS = tuple(bool(a[2]) for a in _AXES)  # rotation about z (else y)


def _const(a: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """A float32 constant of the model on ``ref``'s device."""
    a = np.asarray(a, np.float32)
    return constant(tuple(a.ravel().tolist()), torch.float32, ref.device).reshape(a.shape)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x_{i-1} along the joint axis (-2), zero before the first joint."""
    return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], dim=-2)


def chain_frames(q: torch.Tensor):
    """World rotation, joint origin, world axis and world COM of each joint
    at configs q (..., 7): (R (..., 7, 3, 3), p, ax, c (..., 7, 3))."""
    rz, ry = iiwa._rz(q), iiwa._ry(q)  # (..., 7, 3, 3)
    is_z = constant(_Z_JOINTS, torch.bool, q.device)
    rot = torch.where(is_z[:, None, None], rz, ry)
    Rs = [rot[..., 0, :, :]]
    for i in range(1, 7):
        Rs.append(Rs[-1] @ rot[..., i, :, :])
    R = torch.stack(Rs, dim=-3)
    # p_i = p_{i-1} + R_{i-1} @ trans_i, each trans along z (the base
    # frame's z axis before the first joint)
    base_z = constant((0.0, 0.0, 1.0), torch.float32, q.device)
    R_prev_z = torch.cat([base_z.expand(R.shape[:-3] + (1, 3)), R[..., :-1, :, 2]], dim=-2)
    p = torch.cumsum(R_prev_z * _const(_TRANS[:, 2:], q), dim=-2)
    ax = torch.where(is_z[:, None], R[..., :, 2], R[..., :, 1])
    c = p + torch.einsum("...ij,...j->...i", R, _const(_COMS, q))
    return R, p, ax, c


def fk_flange(q: torch.Tensor) -> torch.Tensor:
    """Flange pose (..., 4, 4) from the dynamics chain; equals ``iiwa.fk``."""
    R, p, _, _ = chain_frames(q)
    R_f = R[..., -1, :, :]
    return tf.pose_from_rt(R_f, p[..., -1, :] + R_f @ _const(_FLANGE, q))


def _rnea_frames(frames, qd: torch.Tensor, qdd: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """RNEA from precomputed ``chain_frames``: joint torques (..., 7) for
    (qd, qdd) (..., 7) under gravity g (..., 3); the frames broadcast
    against the leading axes."""
    R, p, ax, pc = frames
    # forward pass: joint-frame velocities and accelerations
    w = torch.cumsum(ax * qd[..., None], dim=-2)
    w_prev = _shift_down(w)
    dw = torch.cumsum(ax * qdd[..., None] + _cross(w_prev, ax) * qd[..., None], dim=-2)
    dw_prev = _shift_down(dw)
    r = p - _shift_down(p)
    a_o = -g[..., None, :] + torch.cumsum(
        _cross(dw_prev, r) + _cross(w_prev, _cross(w_prev, r)), dim=-2)
    rc = pc - p
    a_c = a_o + _cross(dw, rc) + _cross(w, _cross(w, rc))

    # backward pass: forces and moments about each joint origin, onto the axes
    f = _const(MASSES, qd)[:, None] * a_c
    F = torch.flip(torch.cumsum(torch.flip(f, [-2]), dim=-2), [-2])
    F_next = torch.cat([F[..., 1:, :], torch.zeros_like(F[..., :1, :])], dim=-2)
    p_next = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    I_w = (R * _const(_INERTIA_DIAG, qd)[:, None, :]) @ R.transpose(-1, -2)
    n = (torch.einsum("...ij,...j->...i", I_w, dw)
         + _cross(w, torch.einsum("...ij,...j->...i", I_w, w)))
    terms = n + _cross(rc, f) + _cross(p_next - p, F_next)
    N = torch.flip(torch.cumsum(torch.flip(terms, [-2]), dim=-2), [-2])
    return torch.sum(ax * N, dim=-1)


def _gravity(gravity, ref: torch.Tensor) -> torch.Tensor:
    return _const(GRAVITY, ref) if gravity is None else torch.as_tensor(
        gravity, dtype=torch.float32, device=ref.device)


def rnea(q: torch.Tensor, qd: torch.Tensor, qdd: torch.Tensor,
         gravity: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse dynamics: joint torques (..., 7) realising (q, qd, qdd) under
    ``gravity`` (default: -9.81 m/s^2 along z)."""
    return _rnea_frames(chain_frames(q), qd, qdd, _gravity(gravity, q))


def bias_forces(q, qd, gravity=None):
    """C(q, qd) qd + g(q)."""
    return rnea(q, qd, torch.zeros_like(qd), gravity)


def _rows(frames):
    """The frames with a row axis before the joint axis, so that several
    (qd, qdd, gravity) rows share one RNEA pass."""
    R, p, ax, c = frames
    return (R[..., None, :, :, :],) + tuple(f[..., None, :, :] for f in (p, ax, c))


def mass_matrix(q: torch.Tensor) -> torch.Tensor:
    """M(q) (..., 7, 7): the 7 unit-acceleration RNEA columns (zero
    velocity, zero gravity) as one pass of 7 rows."""
    lead = q.shape[:-1]
    cols = _rnea_frames(_rows(chain_frames(q)), torch.zeros(lead + (7, 7), device=q.device),
                        torch.eye(7, device=q.device).expand(lead + (7, 7)),
                        torch.zeros(lead + (7, 3), device=q.device))
    return cols.transpose(-1, -2)


def _solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M x = b without checking M on the host (no wait for the device)."""
    return torch.linalg.solve_ex(M, b[..., None], check_errors=False)[0][..., 0]


def forward_dynamics(q, qd, tau, gravity=None):
    """qdd = M(q)^-1 (tau - bias)."""
    return _solve(mass_matrix(q), tau - bias_forces(q, qd, gravity))


def pd_torque(q, qd, q_des):
    """Force-limited PD positional servo to rest at ``q_des`` (the output
    torque clamped to ``TORQUE_LIMITS``)."""
    tau = PD_KP * (q_des - q) - PD_KD * qd
    lim = _const(TORQUE_LIMITS, q)
    return torch.clamp(tau, -lim, lim)


def _step_rows(q: torch.Tensor, qd: torch.Tensor):
    """One RNEA pass of 9 rows at q: M (..., 7, 7), the static gravity
    torque g(q) and the bias C(q, qd) qd + g(q) (..., 7)."""
    lead = q.shape[:-1]
    zeros = torch.zeros(lead + (8, 7), device=q.device)
    qd_rows = torch.cat([zeros, qd[..., None, :]], dim=-2)
    qdd_rows = torch.cat([torch.eye(7, device=q.device).expand(lead + (7, 7)),
                          zeros[..., :2, :]], dim=-2)
    g = _const(GRAVITY, q)
    g_rows = torch.cat([torch.zeros(lead + (7, 3), device=q.device),
                        g.expand(lead + (2, 3))], dim=-2)
    tau = _rnea_frames(_rows(chain_frames(q)), qd_rows, qdd_rows, g_rows)
    return tau[..., :7, :].transpose(-1, -2), tau[..., 7, :], tau[..., 8, :]


def track_schedule(q0: torch.Tensor, q_des_traj: torch.Tensor, dt: float = 1.0 / 60):
    """Integrate force-limited PD tracking of a waypoint schedule.

    (T, 7) targets at ``dt`` spacing -> (T, 7) achieved joint positions and
    (T, 7) applied torques (each waypoint's last substep).  Semi-implicit
    Euler at ``dt / SUBSTEPS``.  The servo is inertia-scaled (computed
    torque): M(q)(kp e - kd qd) plus the static gravity torque; the torque
    limit clamps the total command, so saturation still overrides the
    compensation."""
    h = dt / SUBSTEPS
    lim = _const(TORQUE_LIMITS, q0)
    lower, upper = -_const(iiwa.JOINT_LIMITS, q0), _const(iiwa.JOINT_LIMITS, q0)
    q, qd = q0, torch.zeros_like(q0)
    qs, taus = [], []
    for t in range(q_des_traj.shape[-2]):
        q_des = q_des_traj[..., t, :]
        for _ in range(SUBSTEPS):
            M, g_tau, bias = _step_rows(q, qd)
            tau = torch.einsum("...ij,...j->...i", M, TRACK_KP * (q_des - q) - TRACK_KD * qd)
            tau = torch.clamp(tau + g_tau, -lim, lim)
            qdd = _solve(M, tau - bias)
            qd = qd + h * qdd
            q = torch.clamp(q + h * qd, lower, upper)
        qs.append(q)
        taus.append(tau)
    return torch.stack(qs, dim=-2), torch.stack(taus, dim=-2)


def kinetic_energy(q, qd):
    return 0.5 * torch.sum(qd * torch.einsum("...ij,...j->...i", mass_matrix(q), qd), dim=-1)


def potential_energy(q, gravity=None):
    _, _, _, pc = chain_frames(q)
    return -torch.sum(_const(MASSES, q) * (pc @ _gravity(gravity, q)), dim=-1)
