"""Batched SE(3) / similarity transform primitives
(``catgrasp_tpu/core/transforms.py`` in PyTorch).

Every function works on arbitrary leading batch dimensions and keeps the
device and dtype of its inputs.

Conventions
-----------
* Rotations are 3x3 matrices or quaternions in (w, x, y, z) order.
* Rigid poses are 4x4 homogeneous matrices ("pose") or (quat, pos) pairs.
* All angles are radians unless suffixed ``_deg``.
"""
from __future__ import annotations

import math

import torch

from ..device import constant


def _like(values, ref: torch.Tensor) -> torch.Tensor:
    return constant(tuple(values), ref.dtype, ref.device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like ``jnp.cross``."""
    return torch.linalg.cross(a, b, dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis as ``jnp.linalg.norm`` computes it,
    sqrt(sum(v * v)), so both packages round alike."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / (norm(q, keepdim=True) + eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b; rotation composition R(a) @ R(b)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * _like([1.0, -1.0, -1.0, -1.0], q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / (norm(axis, keepdim=True) + 1e-12)
    half = angle[..., None] * 0.5
    vec = axis * torch.sin(half)
    return torch.cat([torch.cos(half).expand(vec.shape[:-1] + (1,)), vec], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), branch-free
    (4-candidate construction, stable for every sign pattern of the trace)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    diag = torch.stack([tr, m00, m11, m22], dim=-1)
    case = torch.argmax(diag, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cases, 4)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.take_along_dim(cands, idx, dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# 4x4 homogeneous poses
# ---------------------------------------------------------------------------


def pose_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = _like([0.0, 0.0, 0.0, 1.0], top).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def pose_from_qt(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(quat, pos) -> 4x4 matrix, batched."""
    return pose_from_rt(quat_to_matrix(q), t)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Shortest-arc spherical interpolation between unit quaternions,
    batched over leading axes of ``alpha``."""
    d = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = torch.abs(d).clamp(0.0, 1.0)
    theta = torch.arccos(d)
    s = torch.sin(theta)
    big = s > 1e-6
    safe_s = torch.where(big, s, torch.ones_like(s))
    w0 = torch.where(big, torch.sin((1 - alpha) * theta) / safe_s, 1 - alpha)
    w1 = torch.where(big, torch.sin(alpha * theta) / safe_s, alpha)
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)


def interpolate_poses(T0: torch.Tensor, T1: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """Waypoint poses between 4x4 transforms T0, T1 (..., 4, 4): translation
    lerp + rotation slerp.  alphas (K,) -> (..., K, 4, 4)."""
    q0 = matrix_to_quat(T0[..., :3, :3])[..., None, :]
    q1 = matrix_to_quat(T1[..., :3, :3])[..., None, :]
    q = quat_slerp(q0, q1, alphas)
    t = (T0[..., None, :3, 3] * (1 - alphas[:, None])
         + T1[..., None, :3, 3] * alphas[:, None])
    return pose_from_qt(q, t)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse: [R t]⁻¹ = [Rᵀ -Rᵀt]. Not valid for scaled transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    return pose_from_rt(Rt, ti)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to points (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def transform_dirs(T: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], dirs)


def to_homo(pts: torch.Tensor) -> torch.Tensor:
    """Append 1 to the last dimension."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


# ---------------------------------------------------------------------------
# Euler (static sxyz convention, matching transformations.euler_matrix)
# ---------------------------------------------------------------------------


def euler_matrix_sxyz(ax, ay, az) -> torch.Tensor:
    """R = Rz(az) @ Ry(ay) @ Rx(ax): static x-y-z convention, 4x4 output."""
    ax, ay, az = torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (ax, ay, az)))
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    R = torch.stack(
        [
            cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
            cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
            -sy, sx * cy, cx * cy,
        ],
        dim=-1,
    ).reshape(ax.shape + (3, 3))
    return pose_from_rt(R, torch.zeros(ax.shape + (3,), device=ax.device))


def rotation_x(a):
    return euler_matrix_sxyz(a, 0.0, 0.0)


def rotation_y(a):
    return euler_matrix_sxyz(0.0, a, 0.0)


def rotation_z(a):
    return euler_matrix_sxyz(0.0, 0.0, a)


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula (3x3)."""
    return quat_to_matrix(quat_from_axis_angle(axis, angle))


# ---------------------------------------------------------------------------
# Misc pose utilities
# ---------------------------------------------------------------------------


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Divide out per-column scale, assuming no shear."""
    scales = torch.linalg.vector_norm(T[..., :3, :3], dim=-2, keepdim=True)
    out = T.clone()
    out[..., :3, :3] = T[..., :3, :3] / (scales + 1e-15)
    return out


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Closest rotation via SVD, flipped to det(+1)."""
    u, _, vh = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vh)
    u = u.clone()
    u[..., :, -1] = u[..., :, -1] * torch.where(det < 0, -1.0, 1.0)[..., None]
    return u @ vh


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle between rotations."""
    cos = (torch.einsum("...ii->...", R1 @ R2.transpose(-1, -2)) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def direction_vec_to_rotation(direction: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Rotation R with R @ ref = direction, branch-free; the antiparallel
    case picks a stable perpendicular axis."""
    d = direction / (norm(direction, keepdim=True) + 1e-12)
    r = ref / (norm(ref, keepdim=True) + 1e-12)
    c = torch.sum(d * r, dim=-1)
    axis = cross(r, d)  # rotate FROM ref TO direction
    s = norm(axis)
    helper = torch.where(torch.abs(r[..., :1]) < 0.9,
                         _like([1.0, 0.0, 0.0], r).expand(r.shape),
                         _like([0.0, 1.0, 0.0], r).expand(r.shape))
    perp = cross(r, helper)
    perp = perp / (norm(perp, keepdim=True) + 1e-12)
    degenerate = s < 1e-8
    safe_axis = torch.where(degenerate[..., None], perp,
                            axis / torch.clamp(s, min=1e-12)[..., None])
    angle = torch.arctan2(s, c)
    angle = torch.where(degenerate, torch.where(c > 0, 0.0, math.pi), angle)
    return axis_angle_to_matrix(safe_axis, angle)


# ---------------------------------------------------------------------------
# Random pose perturbations (jax.random keys -> torch.Generator)
# ---------------------------------------------------------------------------


def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def random_direction(generator: torch.Generator, shape=()) -> torch.Tensor:
    """Uniform direction on the unit sphere."""
    theta = _uniform(generator, shape, 0.0, 2 * math.pi)
    z = _uniform(generator, shape, -1.0, 1.0)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def random_uniform_magnitude(generator: torch.Generator, max_t: float,
                             max_r_deg: float, shape=()) -> torch.Tensor:
    """Random SE(3) perturbation: uniform magnitude translation (<= max_t)
    along a uniform direction and uniform-angle rotation (<= max_r_deg)
    about a uniform axis."""
    t_dir = random_direction(generator, shape)
    t_mag = _uniform(generator, shape, 0.0, max_t)
    t = t_dir * t_mag[..., None]
    r_dir = random_direction(generator, shape)
    r_mag = _uniform(generator, shape, 0.0, max_r_deg) * math.pi / 180.0
    return pose_from_rt(axis_angle_to_matrix(r_dir, r_mag), t)
