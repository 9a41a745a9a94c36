"""KUKA iiwa14 forward kinematics and the batched IK-feasibility gate
(``catgrasp_tpu/kin/iiwa.py`` in PyTorch).

The iiwa's S-R-S structure makes its 7-DoF redundancy one scalar arm angle
ψ; for each ψ the 6-DoF remainder is closed-form with 8 branches (elbow ±,
shoulder ±, wrist ±).  Sampling ψ on a static grid turns IK into a
fixed-shape batched computation: ``ik`` maps poses (..., 4, 4) to
(..., 8*n_psi, 7) candidate solutions and a validity mask, and the
feasibility gate ``ik_feasible`` answers "any valid candidate" without
building them.

Kinematic convention (standard iiwa14 dimensions):
  T_0F(q) = Tz(.36)·Rz(q1)Ry(q2)Rz(q3)·Tz(.42)·Ry(q4)·Tz(.40)·Rz(q5)Ry(q6)Rz(q7)·Tz(.126)
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import transforms as tf
from ..device import constant

D_BS = 0.36
D_SE = 0.42
D_EW = 0.40
D_WF = 0.126

# Joint limits in radians (iiwa14 spec: ±170,±120,±170,±120,±170,±120,±175 deg)
JOINT_LIMITS = np.deg2rad(np.array([170.0, 120.0, 170.0, 120.0, 170.0, 120.0, 175.0]))
N_PSI = 32  # arm-angle grid

_TAN10 = float(np.tan(np.deg2rad(10.0)))  # ±170° interval test slope
_TAN5 = float(np.tan(np.deg2rad(5.0)))    # ±175°
_COS120 = float(np.cos(np.deg2rad(120.0)))
_Q4_LIMIT = float(np.float32(JOINT_LIMITS[3]))
_LIMITS_F32 = JOINT_LIMITS.astype(np.float32)
_POSES_PER_CHUNK = 1 << 16  # bounds the (poses, n_psi, 3) intermediates


def _rz(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).reshape(a.shape + (3, 3))


def _ry(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1).reshape(a.shape + (3, 3))


def fk(q: torch.Tensor) -> torch.Tensor:
    """Flange pose (4x4) for joint vector q (..., 7)."""
    return fk_frames(q)[-1]


def fk_frames(q: torch.Tensor):
    """Key frames along the chain for q (..., 7): (T_S, T_E, T_W, T_F), each
    (..., 4, 4) — shoulder, elbow, wrist, flange."""
    q1, q2, q3, q4, q5, q6, q7 = [q[..., i] for i in range(7)]
    batch = q.shape[:-1]

    def vec(*v):
        return constant(v, q.dtype, q.device)

    R03 = _rz(q1) @ _ry(q2) @ _rz(q3)
    p_s = vec(0.0, 0.0, D_BS).expand(batch + (3,))
    T_S = tf.pose_from_rt(R03, p_s)

    p_e = p_s + torch.einsum("...ij,j->...i", R03, vec(0.0, 0.0, D_SE))
    R04 = R03 @ _ry(q4)
    T_E = tf.pose_from_rt(R04, p_e)

    p_w = p_e + torch.einsum("...ij,j->...i", R04, vec(0.0, 0.0, D_EW))
    R07 = R04 @ _rz(q5) @ _ry(q6) @ _rz(q7)
    T_W = tf.pose_from_rt(R07, p_w)

    p_f = p_w + torch.einsum("...ij,j->...i", R07, vec(0.0, 0.0, D_WF))
    T_F = tf.pose_from_rt(R07, p_f)
    return T_S, T_E, T_W, T_F


def _psi_grid(n_psi: int, dev) -> torch.Tensor:
    """The arm-angle grid, as ``jnp.linspace(0, 2pi, n_psi, endpoint=False)``
    computes it."""
    two_pi = constant(2 * math.pi, torch.float32, dev)
    return two_pi * (torch.arange(n_psi, dtype=torch.float32, device=dev) / n_psi)


def _euler_zyz(R):
    """Both ZYZ decompositions of R (..., 3, 3): (a, b, c), each (..., 2),
    with R = Rz(a) Ry(b) Rz(c).  At the b≈0 singularity the spin folds
    into ``a``; b≈pi is outside the ±120° limit of joints 2, 4 and 6."""
    r02, r12, r22 = R[..., 0, 2], R[..., 1, 2], R[..., 2, 2]
    r20, r21 = R[..., 2, 0], R[..., 2, 1]
    r00, r10 = R[..., 0, 0], R[..., 1, 0]
    sb = torch.sqrt(torch.clamp(r02**2 + r12**2, min=0.0))
    degen = sb < 1e-7

    b1 = torch.arctan2(sb, r22)
    a1 = torch.where(degen, torch.arctan2(r10, r00), torch.arctan2(r12, r02))
    c1 = torch.where(degen, 0.0, torch.arctan2(r21, -r20))

    b2 = -b1
    a2 = torch.where(degen, a1, torch.arctan2(-r12, -r02))
    c2 = torch.where(degen, c1, torch.arctan2(-r21, r20))
    return (torch.stack([a1, a2], dim=-1), torch.stack([b1, b2], dim=-1),
            torch.stack([c1, c2], dim=-1))


def _wrap_pi(q: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi) as ``jnp.mod(q + pi, 2 pi) - pi`` does (a
    truncated remainder, moved up by 2 pi where it is negative)."""
    two_pi = constant(2 * math.pi, q.dtype, q.device)
    r = torch.fmod(q + math.pi, two_pi)
    return torch.where((r != 0) & (r < 0), r + two_pi, r) - math.pi


def ik(T: torch.Tensor, n_psi: int = N_PSI):
    """All candidate joint solutions for flange poses T (..., 4, 4).

    Returns ``(q, valid)`` with q (..., 8*n_psi, 7) and valid
    (..., 8*n_psi) bool (within joint limits AND position-solvable).
    Branch layout: psi-grid x elbow± x shoulder± x wrist±."""
    dev = T.device
    R = T[..., :3, :3]
    p = T[..., :3, 3]
    p_w = p - R[..., :, 2] * D_WF
    sw = p_w - constant((0.0, 0.0, D_BS), torch.float32, dev)
    d_sw = tf.norm(sw)

    # --- elbow angle (2 branches) ---
    cos_q4 = (d_sw**2 - D_SE**2 - D_EW**2) / (2 * D_SE * D_EW)
    reachable = torch.abs(cos_q4) <= 1.0
    q4_mag = torch.arccos(torch.clamp(cos_q4, -1.0, 1.0))
    q4 = torch.stack([q4_mag, -q4_mag], dim=-1)  # (..., 2)
    u_sw = sw / torch.clamp(d_sw, min=1e-9)[..., None]
    psi = _psi_grid(n_psi, dev)

    # reference shoulder config (q3 = 0): Rz(q1)Ry(q2) v = sw, with v the
    # elbow-to-wrist offset (vx, 0, vz) in the upper-arm frame
    vx = D_EW * torch.sin(q4)
    vz = D_SE + D_EW * torch.cos(q4)
    r_xy = torch.sqrt(sw[..., 0] ** 2 + sw[..., 1] ** 2)
    q1_0 = torch.arctan2(sw[..., 1], sw[..., 0])
    theta_sw = torch.arctan2(r_xy, sw[..., 2])
    q2_0 = theta_sw[..., None] - torch.arctan2(vx, vz)  # (..., 2)
    R03_ref = _rz(q1_0)[..., None, :, :] @ _ry(q2_0)  # (..., 2, 3, 3)

    # arm-angle rotation about the SW axis
    R_psi = tf.axis_angle_to_matrix(u_sw[..., None, :], psi)  # (..., P, 3, 3)
    R03 = R_psi[..., :, None, :, :] @ R03_ref[..., None, :, :, :]  # (..., P, 2, 3, 3)

    # shoulder ZYZ (2 branches), then the wrist of each (2 branches)
    a_s, b_s, c_s = _euler_zyz(R03)  # (..., P, 2e, 2s)
    R03b = _rz(a_s) @ _ry(b_s) @ _rz(c_s)
    q4_b = q4[..., None, :, None].expand(a_s.shape)
    R47 = _ry(-q4_b) @ R03b.transpose(-1, -2) @ R[..., None, None, None, :, :]
    a_w, b_w, c_w = _euler_zyz(R47)  # (..., P, 2e, 2s, 2w)

    def wide(x):
        return x[..., None].expand(a_w.shape)

    qs = torch.stack([wide(a_s), wide(b_s), wide(c_s), wide(q4_b), a_w, b_w, c_w], dim=-1)
    qs = _wrap_pi(qs.reshape(T.shape[:-2] + (8 * n_psi, 7)))
    lim = constant(tuple(_LIMITS_F32.tolist()), torch.float32, dev)
    within = torch.all((qs <= lim) & (qs >= -lim), dim=-1)
    return qs, within & reachable[..., None]


def ik_best(T: torch.Tensor, q_ref: torch.Tensor | None = None, n_psi: int = N_PSI):
    """Single best IK solution of each pose (..., 4, 4): the valid candidate
    closest to ``q_ref`` (or to zero).  Returns (q (..., 7), found)."""
    qs, valid = ik(T, n_psi)
    ref = torch.zeros(7, device=T.device) if q_ref is None else q_ref
    cost = torch.sum((qs - ref[..., None, :]) ** 2, dim=-1)
    cost = torch.where(valid, cost, float("inf"))
    i = torch.argmin(cost, dim=-1, keepdim=True)
    q = torch.take_along_dim(qs, i[..., None], dim=-2)[..., 0, :]
    return q, torch.take_along_dim(valid, i, dim=-1)[..., 0]


# ``ik`` takes any leading axes: the JAX package's vmapped ``ik_batch`` is
# ``ik`` of a (B, 4, 4) batch
ik_batch = ik


def _rodrigues(u, cps, sps, v):
    """Rot(u, ψ) @ v for a batch of ψ: u (...,3), cps/sps (..., n_psi),
    v (..., 3) -> (..., n_psi, 3)."""
    udv = torch.sum(u * v, dim=-1)[..., None, None]
    uxv = tf.cross(u, v)[..., None, :]
    return (v[..., None, :] * cps[..., None] + uxv * sps[..., None]
            + u[..., None, :] * udv * (1.0 - cps[..., None]))


def _spin_ok(x, y, slope):
    """|atan2(y, x)| <= pi - atan(slope): NOT inside the cone around ±pi."""
    return ~((x < 0.0) & (torch.abs(y) <= -x * slope))


def _ik_feasible(Ts: torch.Tensor, n_psi: int) -> torch.Tensor:
    dev = Ts.device
    R = Ts[..., :3, :3]
    p = Ts[..., :3, 3]
    p_w = p - R[..., :, 2] * D_WF
    sw = p_w - constant((0.0, 0.0, D_BS), torch.float32, dev)
    d2 = torch.sum(sw * sw, dim=-1)
    d_sw = torch.sqrt(d2)

    cos_q4 = (d2 - D_SE**2 - D_EW**2) / (2 * D_SE * D_EW)
    reachable = torch.abs(cos_q4) <= 1.0
    q4m = torch.arccos(torch.clamp(cos_q4, -1.0, 1.0))
    elbow_ok = q4m <= _Q4_LIMIT

    u = sw / torch.clamp(d_sw, min=1e-9)[..., None]
    psi = _psi_grid(n_psi, dev)
    bshape = Ts.shape[:-2] + (n_psi,)
    cps = torch.cos(psi).expand(bshape)
    sps = torch.sin(psi).expand(bshape)

    rxy = torch.sqrt(sw[..., 0] ** 2 + sw[..., 1] ** 2)
    q1_0 = torch.arctan2(sw[..., 1], sw[..., 0])
    theta_sw = torch.arctan2(rxy, sw[..., 2])

    e_z = constant((0.0, 0.0, 1.0), torch.float32, dev).expand(u.shape)
    rot_neg_ez = _rodrigues(u, cps, -sps, e_z)
    rot_neg_rz = _rodrigues(u, cps, -sps, R[..., :, 2])

    def per_elbow(q4):
        vx = D_EW * torch.sin(q4)
        vz = D_SE + D_EW * torch.cos(q4)
        q2_0 = theta_sw - torch.arctan2(vx, vz)
        c1, s1 = torch.cos(q1_0), torch.sin(q1_0)
        c2, s2 = torch.cos(q2_0), torch.sin(q2_0)

        def ref_apply(v, C1, S1, C2, S2):  # R03_ref @ v
            x = C2 * v[..., 0] + S2 * v[..., 2]
            z = -S2 * v[..., 0] + C2 * v[..., 2]
            return torch.stack([C1 * x - S1 * v[..., 1], S1 * x + C1 * v[..., 1], z], dim=-1)

        def ref_apply_T(v, C1, S1, C2, S2):  # R03_refᵀ @ v
            x = C1 * v[..., 0] + S1 * v[..., 1]
            y = -S1 * v[..., 0] + C1 * v[..., 1]
            return torch.stack([C2 * x - S2 * v[..., 2], y, S2 * x + C2 * v[..., 2]], dim=-1)

        C1, S1, C2, S2 = (a[..., None] for a in (c1, s1, c2, s2))

        col2 = _rodrigues(u, cps, sps, ref_apply(e_z, c1, s1, c2, s2))
        row2 = ref_apply_T(rot_neg_ez, C1, S1, C2, S2)
        r02, r12, r22 = col2[..., 0], col2[..., 1], col2[..., 2]
        r20, r21 = row2[..., 0], row2[..., 1]
        sh_b = r22 >= _COS120
        sh_1 = _spin_ok(r02, r12, _TAN10) & _spin_ok(-r20, r21, _TAN10)
        sh_2 = _spin_ok(-r02, -r12, _TAN10) & _spin_ok(r20, -r21, _TAN10)
        degen_s = r02**2 + r12**2 < 1e-14
        sh_ok = sh_b & (degen_s | sh_1 | sh_2)

        c4, s4 = torch.cos(q4), torch.sin(q4)
        wz = ref_apply_T(rot_neg_rz, C1, S1, C2, S2)
        r02w = c4[..., None] * wz[..., 0] - s4[..., None] * wz[..., 2]
        r12w = wz[..., 1]
        r22w = s4[..., None] * wz[..., 0] + c4[..., None] * wz[..., 2]
        mv = torch.stack([s4, torch.zeros_like(s4), c4], dim=-1)
        m = _rodrigues(u, cps, sps, ref_apply(mv, c1, s1, c2, s2))
        r20w = torch.sum(m * R[..., None, :, 0], dim=-1)
        r21w = torch.sum(m * R[..., None, :, 1], dim=-1)
        wr_b = r22w >= _COS120
        wr_1 = _spin_ok(r02w, r12w, _TAN10) & _spin_ok(-r20w, r21w, _TAN5)
        wr_2 = _spin_ok(-r02w, -r12w, _TAN10) & _spin_ok(r20w, -r21w, _TAN5)
        degen_w = r02w**2 + r12w**2 < 1e-14
        wr_ok = wr_b & (degen_w | wr_1 | wr_2)
        return torch.any(sh_ok & wr_ok, dim=-1)

    ok = per_elbow(q4m) | per_elbow(-q4m)
    return ok & reachable & elbow_ok


def ik_feasible(Ts: torch.Tensor, n_psi: int = N_PSI) -> torch.Tensor:
    """Branch-free IK-feasibility gate over poses (B, 4, 4) -> (B,) bool.

    Shoulder and wrist feasibility test independently (the wrist rotation
    does not depend on which shoulder ZYZ branch is taken), and each joint
    limit is a sign/ratio comparison on matrix elements, so the ψ sweep is
    Rodrigues rotations of a few fixed vectors.  Poses run in chunks to
    bound the (poses, n_psi, 3) intermediates."""
    out = [_ik_feasible(Ts[s:s + _POSES_PER_CHUNK], n_psi)
           for s in range(0, Ts.shape[0], _POSES_PER_CHUNK)]
    if not out:
        return torch.zeros((0,), dtype=torch.bool, device=Ts.device)
    return torch.cat(out)
