"""Batched free-pile physics with the state on chip: CUDA kernel K3
``rollout_fused`` (``csrc/fused_rollout.cu``, the port of the Pallas kernel
``catgrasp_tpu/ops/fused_rollout.py:rollout_fused``) and its plain PyTorch
version.

One call runs ``n_steps`` physics steps of every scene of a batch: gravity,
narrowphase (every surface point against every other body's CSG and every
env box, giving phi, normal and K_n), ``n_iter`` Jacobi split-impulse
iterations (a real channel with cone-clamped friction and a pseudo channel
driven by the Baumgarte bias), damping and semi-implicit Euler.  It is the
throughput path of ``catgrasp_tpu_torch.bench``; it differs from
``sim.engine.step`` on purpose (no exact tangential mass, no passivity
guard: free piles only, no grip colliders).

Numerical contract shared by kernel and plain version: phi and the normal
are rounded to bf16 (nearest even) after K_n and the contact counts have
been taken from their f32 values, and every Jacobi iteration reads the
rounded values.

``rollout_fused`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  The per-scene gathers
(surface points and CSG rows by ``shape_id``, inverse mass and inertia, env
rotation matrices) are done once a call: by the kernel while it stages a
scene, from the tensors as the caller holds them, and in PyTorch by
``prepare`` for the plain version.  ``stage_plain`` is the kernel's staging
written out in PyTorch, scene by scene; the tests hold it to ``prepare``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..core import transforms as tf
from ..geom.csg import BOX, COS30, CYLINDER, NONE
from ..sim.engine import BAUMGARTE, DT, FRICTION_RELAX, SLOP, STATIC_MASS, StaticEnv
from ..sim.types import SceneParams, SceneState, ShapeLib
from . import build

MAX_SLOTS = 4  # CSG slots a body, as the kernel stages them
MAX_COLLIDERS = 32  # bodies + env boxes: one contact bit each in a 32-bit mask
MAX_THREADS = 512  # one thread per (body, surface point) pair of a scene
MAX_SMEM_BYTES = 232_448  # dynamic shared memory a block may ask for on Hopper


# ---------------------------------------------------------------------------
# per-primitive SDF + outward normal, component by component
# ---------------------------------------------------------------------------


def box_sdfn(px, py, pz, hx, hy, hz):
    """Analytic box SDF + outward normal (d, nx, ny, nz)."""
    qx, qy, qz = torch.abs(px) - hx, torch.abs(py) - hy, torch.abs(pz) - hz
    ox, oy, oz = torch.clamp(qx, min=0.0), torch.clamp(qy, min=0.0), torch.clamp(qz, min=0.0)
    d_out = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-18)
    qmax = torch.maximum(qx, torch.maximum(qy, qz))
    d_in = torch.clamp(qmax, max=0.0)
    inv_do = 1.0 / d_out
    outside = (qx > 0) | (qy > 0) | (qz > 0)
    nx = torch.where(outside, ox * inv_do, (qx >= qmax).to(px.dtype)) * torch.sign(px)
    ny = torch.where(outside, oy * inv_do, (qy >= qmax).to(py.dtype)) * torch.sign(py)
    nz = torch.where(outside, oz * inv_do, (qz >= qmax).to(pz.dtype)) * torch.sign(pz)
    return d_out + d_in, nx, ny, nz


def cyl_sdfn(px, py, pz, r, hh):
    """Analytic z-cylinder SDF + outward normal."""
    rxy = torch.sqrt(px * px + py * py + 1e-18)
    inv_rxy = 1.0 / rxy
    dxy = rxy - r
    dz = torch.abs(pz) - hh
    ox, oz = torch.clamp(dxy, min=0.0), torch.clamp(dz, min=0.0)
    d_out = torch.sqrt(ox * ox + oz * oz + 1e-18)
    d_in = torch.clamp(torch.maximum(dxy, dz), max=0.0)
    inv_do = 1.0 / d_out
    out = (ox + oz) > 0.0
    # radial vs cap weights
    wr = torch.where(out, ox * inv_do, (dxy > dz).to(px.dtype))
    wz = torch.where(out, oz * inv_do, (dxy <= dz).to(px.dtype))
    nx = wr * px * inv_rxy
    ny = wr * py * inv_rxy
    nz = wz * torch.sign(pz)
    return torch.where(out, d_out, 0.0) + d_in, nx, ny, nz


def hex_sdfn(px0, py0, pz0, ap, hh):
    """Analytic z-hex-prism SDF + outward normal (vertex on +x)."""
    kx, ky, kz = -COS30, 0.5, 0.57735
    s1, s2, sz = torch.sign(px0), torch.sign(py0), torch.sign(pz0)
    px, py, pz = torch.abs(px0), torch.abs(py0), torch.abs(pz0)
    dot = kx * px + ky * py
    folded = dot < 0.0
    mdot = torch.clamp(dot, max=0.0)
    px2 = px - 2.0 * mdot * kx
    py2 = py - 2.0 * mdot * ky
    lim = kz * ap
    clipped = torch.minimum(torch.maximum(px2, -lim), lim)
    lx = px2 - clipped
    ly = py2 - ap
    llen = torch.sqrt(lx * lx + ly * ly + 1e-18)
    side = torch.sign(py2 - ap)
    dx = llen * side
    dz = pz - hh
    active = (px2 != clipped).to(px.dtype)
    inv_ll = 1.0 / llen
    gx = side * lx * inv_ll * active
    gy = side * ly * inv_ll
    kg = kx * gx + ky * gy
    gx = torch.where(folded, gx - 2.0 * kx * kg, gx)
    gy = torch.where(folded, gy - 2.0 * ky * kg, gy)
    ox, oz = torch.clamp(dx, min=0.0), torch.clamp(dz, min=0.0)
    d_out = torch.sqrt(ox * ox + oz * oz + 1e-18)
    outside = (ox + oz) > 0.0
    d_in = torch.clamp(torch.maximum(dx, dz), max=0.0)
    inv_do = 1.0 / d_out
    w2d = torch.where(outside, ox * inv_do, (dx > dz).to(px.dtype))
    wz = torch.where(outside, oz * inv_do, (dx <= dz).to(px.dtype))
    nx = w2d * s1 * gx
    ny = w2d * s2 * gy
    nz = wz * sz
    gn = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-18)
    return torch.where(outside, d_out, 0.0) + d_in, nx * gn, ny * gn, nz * gn


def csg_evaln(lx, ly, lz, types, ops, prm, off):
    """CSG signed distance and outward normal in the local frame.

    lx/ly/lz: local coordinates of any shape.  The slot axis leads the shape
    tables: types/ops (S, ...), prm/off (S, 3, ...), each slot's entry
    broadcasting against the coordinates.  Returns (d, nx, ny, nz)."""
    d = torch.full_like(lx, 1e9)
    nx, ny, nz = torch.zeros_like(lx), torch.zeros_like(lx), torch.zeros_like(lx)
    for s in range(types.shape[0]):
        px, py, pz = lx - off[s, 0], ly - off[s, 1], lz - off[s, 2]
        t = types[s]
        db, bx, by, bz = box_sdfn(px, py, pz, prm[s, 0], prm[s, 1], prm[s, 2])
        dc, cx, cy, cz = cyl_sdfn(px, py, pz, prm[s, 0], prm[s, 1])
        dh, hx, hy, hz = hex_sdfn(px, py, pz, prm[s, 0], prm[s, 1])
        is_b, is_c = t == BOX, t == CYLINDER
        ds = torch.where(is_b, db, torch.where(is_c, dc, dh))
        sx = torch.where(is_b, bx, torch.where(is_c, cx, hx))
        sy = torch.where(is_b, by, torch.where(is_c, cy, hy))
        sz = torch.where(is_b, bz, torch.where(is_c, cz, hz))
        is_union = ops[s] > 0
        take_u = is_union & (ds < d)
        take_s = ~is_union & (-ds > d)
        d_new = torch.where(is_union, torch.minimum(d, ds), torch.maximum(d, -ds))
        live = t != NONE
        d = torch.where(live, d_new, d)
        upd = live & (take_u | take_s)
        sgn = torch.where(take_u, 1.0, -1.0)
        nx = torch.where(upd, sgn * sx, nx)
        ny = torch.where(upd, sgn * sy, ny)
        nz = torch.where(upd, sgn * sz, nz)
    gn = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-18)
    return d, nx * gn, ny * gn, nz * gn


# ---------------------------------------------------------------------------
# per-call gathers, shared by the kernel and the plain version
# ---------------------------------------------------------------------------


@dataclass
class Prepared:
    """Per-scene constants of one call (B scenes, N bodies, P points, S slots,
    M env boxes), all float32 and contiguous unless noted."""

    body: torch.Tensor  # (B, N, 8): active, dynamic, 1/mass, 1/inertia xyz, friction, scale
    surf: torch.Tensor  # (B, N, P, 3) body-frame sample points, scaled
    csg_i: torch.Tensor  # (B, N, 2S) int32: slot types, slot ops
    csg_f: torch.Tensor  # (B, N, 6S): slot params (S, 3), slot offsets (S, 3)
    env: torch.Tensor  # (M, 19): center, half, R row-major, velocity, friction


def prepare(state: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv) -> Prepared:
    """The gathers a call needs once: surface points and CSG rows by
    ``shape_id``, inverse mass and inertia (0 for static or inactive bodies),
    env rotation matrices; a disabled env box is moved to 1e6 and its
    velocity zeroed."""
    B, N = state.pos.shape[:2]
    sid = params.shape_id
    S = lib.csg.types.shape[1]
    surf = lib.surf_pts[sid] * params.scale[..., None, None]
    act = state.active
    dyn = act & (params.mass < STATIC_MASS)
    inv_m = torch.where(dyn, 1.0 / params.mass, 0.0)
    inv_i = torch.where(dyn[..., None], 1.0 / params.inertia, 0.0)
    body = torch.cat([act[..., None].float(), dyn[..., None].float(), inv_m[..., None], inv_i,
                      params.friction[..., None], params.scale[..., None]], dim=-1)
    csg_i = torch.cat([lib.csg.types[sid], lib.csg.ops[sid]], dim=-1).to(torch.int32)
    csg_f = torch.cat([lib.csg.params[sid].reshape(B, N, 3 * S),
                       lib.csg.offsets[sid].reshape(B, N, 3 * S)], dim=-1)
    on = env.enabled[:, None]
    env_f = torch.cat([torch.where(on, env.center, 1e6), env.half,
                       tf.quat_to_matrix(env.quat).reshape(-1, 9),
                       torch.where(on, env.vel, 0.0), env.friction[:, None]], dim=-1)
    return Prepared(body=body.float().contiguous(), surf=surf.float().contiguous(),
                    csg_i=csg_i.contiguous(), csg_f=csg_f.float().contiguous(),
                    env=env_f.float().contiguous())


def csg_bound_radius(csg) -> torch.Tensor:
    """(K,) radius about the shape origin, at unit scale, of a sphere that
    holds each CSG of the stacked ``csg``: the farthest reach of its union
    slots (a subtraction only removes).  The kernel tests a point against
    this sphere, widened by 0.1% and 1 um, before it evaluates the CSG; a
    hex prism's corner lies at apothem * sqrt(1 + 0.57735^2) < 1.1548
    apothem."""
    t, q = csg.types, csg.params
    is_box = t == BOX
    a = torch.where(is_box | (t == CYLINDER), q[..., 0], 1.1548 * q[..., 0])
    b = torch.where(is_box, q[..., 1], 0.0)
    c = torch.where(is_box, q[..., 2], q[..., 1])
    reach = torch.linalg.vector_norm(csg.offsets, dim=-1) + torch.sqrt(a * a + b * b + c * c)
    return torch.where((t != NONE) & (csg.ops > 0), reach, 0.0).amax(dim=-1)


def stage_plain(state: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv,
                scene: int) -> Prepared:
    """What the kernel's block stages for scene ``scene``, written out body by
    body and env box by env box from the tensors as the caller holds them:
    the counterpart of ``prepare`` for one scene (leading axis 1)."""
    N, S = state.pos.shape[1], lib.csg.types.shape[1]
    dev = state.pos.device
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    body, surf, csg_i, csg_f = [], [], [], []
    for b in range(N):
        sid = int(params.shape_id[scene, b])
        mass, scale = params.mass[scene, b], params.scale[scene, b]
        act = bool(state.active[scene, b])
        dyn = act and bool(mass < STATIC_MASS)
        inv_m = one / mass if dyn else zero
        inv_i = [one / params.inertia[scene, b, k] if dyn else zero for k in range(3)]
        body.append(torch.stack([one * act, one * dyn, inv_m, *inv_i,
                                 params.friction[scene, b], scale]))
        surf.append(lib.surf_pts[sid] * scale)
        csg_i.append(torch.cat([lib.csg.types[sid], lib.csg.ops[sid]]).to(torch.int32))
        csg_f.append(torch.cat([lib.csg.params[sid].reshape(3 * S),
                                lib.csg.offsets[sid].reshape(3 * S)]))
    rows = []
    for m in range(env.center.shape[0]):
        on = bool(env.enabled[m])
        q = env.quat[m]
        nrm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12
        w, x, y, z = (q[k] / nrm for k in range(4))
        rot = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
               2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
               2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
        center = env.center[m] if on else torch.full((3,), 1e6, device=dev)
        rows.append(torch.cat([center, env.half[m],
                               torch.stack(rot), env.vel[m] if on else torch.zeros(3, device=dev),
                               env.friction[m:m + 1]]))
    return Prepared(body=torch.stack(body)[None].float(), surf=torch.stack(surf)[None].float(),
                    csg_i=torch.stack(csg_i)[None], csg_f=torch.stack(csg_f)[None].float(),
                    env=torch.stack(rows).float() if rows else torch.zeros((0, 19), device=dev))


def _step_constants(dt, gravity, linear_damping, angular_damping):
    """(g*dt, Baumgarte/dt, linear keep, angular keep); damping is calibrated
    per 1/240 s step and rescaled to the actual dt."""
    return (gravity * dt, BAUMGARTE / dt, (1.0 - linear_damping) ** (dt / DT),
            (1.0 - angular_damping) ** (dt / DT))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _rotation_components(quat):
    """quat (B, N, 4) -> 9 rotation components [(B, N)], row-major."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    return [
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ]


def _bf16(x):
    return x.to(torch.bfloat16).float()


class Frame:
    """What one step derives from the poses before its narrowphase: rotation
    components, world surface points and world inverse inertia."""

    def __init__(self, pos, quat, c: Prepared):
        self.pos = pos
        self.R = R = _rotation_components(quat)  # 9 x (B, N)
        surf = c.surf
        # world surface points w[c]: (B, N, P)
        self.w = [pos[..., k, None] + sum(R[3 * k + m][..., None] * surf[..., m]
                                          for m in range(3)) for k in range(3)]
        i_inv = c.body[..., 3:6]

        def i_world(a, b):
            return sum(R[3 * a + k] * i_inv[..., k] * R[3 * b + k] for k in range(3))

        self.I = (i_world(0, 0), i_world(0, 1), i_world(0, 2),
                  i_world(1, 1), i_world(1, 2), i_world(2, 2))
        # lever arms of every point about its own body: (B, N, P)
        self.ri = [self.w[k] - pos[..., k, None] for k in range(3)]

    def apply_inv_inertia(self, sel, tx, ty, tz):
        """I_world^-1 of the bodies ``sel`` (a slice over N, or one index)
        times the vector (tx, ty, tz)."""
        def c(comp):
            v = comp[:, sel]
            while v.dim() < tx.dim():
                v = v[..., None]
            return v

        i00, i01, i02, i11, i12, i22 = self.I
        return (c(i00) * tx + c(i01) * ty + c(i02) * tz,
                c(i01) * tx + c(i11) * ty + c(i12) * tz,
                c(i02) * tx + c(i12) * ty + c(i22) * tz)

    def rj(self, j):
        """Lever arms of every point about body j: 3 x (B, N, P)."""
        return [self.w[k] - self.pos[:, j, k, None, None] for k in range(3)]


def narrowphase(fr: Frame, c: Prepared):
    """phi, world normal and K_n of every (point, collider) pair, collider by
    collider, and the Jacobi averaging scale of every body.

    Returns (slabs, scale_body): ``slabs[j]`` is (phi, nx, ny, nz, kn), each
    (B, N, P), with phi and the normal rounded to bf16; ``scale_body`` (B, N)
    is 1 / max(contacts the body takes part in, 1), counted on f32 phi."""
    pos, R, w = fr.pos, fr.R, fr.w
    B, N = pos.shape[:2]
    S = c.csg_i.shape[-1] // 2
    M_env = c.env.shape[0]
    act, inv_m, scl = c.body[..., 0], c.body[..., 2], c.body[..., 7]
    envc, envh, envR = c.env[:, 0:3], c.env[:, 3:6], c.env[:, 6:15].reshape(-1, 3, 3)
    cnt_i = torch.zeros_like(act)
    cnt_j = []
    slabs = []
    eye = torch.eye(N, device=pos.device)
    for j in range(N + M_env):
        if j < N:
            # body collider: the points in j's frame
            rel = fr.rj(j)
            Rj = [R[k][:, j, None, None] for k in range(9)]
            inv_s = (1.0 / scl[:, j])[:, None, None]
            loc = [(Rj[0 + k] * rel[0] + Rj[3 + k] * rel[1] + Rj[6 + k] * rel[2]) * inv_s
                   for k in range(3)]
            row_i = c.csg_i[:, j].permute(1, 0)[..., None, None]  # (2S, B, 1, 1)
            row_f = c.csg_f[:, j].permute(1, 0).reshape(2, S, 3, B, 1, 1)
            phi, gx, gy, gz = csg_evaln(loc[0], loc[1], loc[2], row_i[:S], row_i[S:],
                                        row_f[0], row_f[1])
            phi = phi * scl[:, j, None, None]
            nx = Rj[0] * gx + Rj[1] * gy + Rj[2] * gz
            ny = Rj[3] * gx + Rj[4] * gy + Rj[5] * gz
            nz = Rj[6] * gx + Rj[7] * gy + Rj[8] * gz
            ok = act * act[:, j, None] * (1.0 - eye[j])  # no self pair, both active
            phi = torch.where(ok[..., None] > 0, phi, 1e9)
        else:
            m = j - N
            rel = [w[k] - envc[m, k] for k in range(3)]
            loc = [envR[m, 0, k] * rel[0] + envR[m, 1, k] * rel[1] + envR[m, 2, k] * rel[2]
                   for k in range(3)]
            qx = torch.abs(loc[0]) - envh[m, 0]
            qy = torch.abs(loc[1]) - envh[m, 1]
            qz = torch.abs(loc[2]) - envh[m, 2]
            ox, oy, oz = (torch.clamp(qx, min=0.0), torch.clamp(qy, min=0.0),
                          torch.clamp(qz, min=0.0))
            d_out = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-18)
            qmax = torch.maximum(qx, torch.maximum(qy, qz))
            phi = d_out + torch.clamp(qmax, max=0.0)
            outside = qmax > 0.0
            inv_do = 1.0 / d_out
            zero = torch.zeros_like(qx)
            nlx = torch.where(outside, ox * inv_do * torch.sign(loc[0]),
                              torch.where(qx >= qmax, torch.sign(loc[0]), zero))
            nly = torch.where(outside, oy * inv_do * torch.sign(loc[1]),
                              torch.where(qy >= qmax, torch.sign(loc[1]), zero))
            nlz = torch.where(outside, oz * inv_do * torch.sign(loc[2]),
                              torch.where(qz >= qmax, torch.sign(loc[2]), zero))
            gn = torch.rsqrt(nlx * nlx + nly * nly + nlz * nlz + 1e-12)
            nlx, nly, nlz = nlx * gn, nly * gn, nlz * gn
            nx = envR[m, 0, 0] * nlx + envR[m, 0, 1] * nly + envR[m, 0, 2] * nlz
            ny = envR[m, 1, 0] * nlx + envR[m, 1, 1] * nly + envR[m, 1, 2] * nlz
            nz = envR[m, 2, 0] * nlx + envR[m, 2, 1] * nly + envR[m, 2, 2] * nlz
            phi = torch.where(act[..., None] > 0, phi, 1e9)

        contact = (phi < 0.0).to(phi.dtype)
        cnt_i = cnt_i + torch.sum(contact, dim=2)
        if j < N:
            cnt_j.append(torch.sum(contact, dim=(1, 2)))

        # K_n = 1/mi + 1/mj + n.[(Ii^-1 (ri x n)) x ri] + (j term)
        ri = fr.ri
        cx = ri[1] * nz - ri[2] * ny
        cy = ri[2] * nx - ri[0] * nz
        cz = ri[0] * ny - ri[1] * nx
        ax, ay, az = fr.apply_inv_inertia(slice(None), cx, cy, cz)
        term_i = cx * ax + cy * ay + cz * az
        if j < N:
            rj = fr.rj(j)
            jx = rj[1] * nz - rj[2] * ny
            jy = rj[2] * nx - rj[0] * nz
            jz = rj[0] * ny - rj[1] * nx
            bx, by, bz = fr.apply_inv_inertia(slice(j, j + 1), jx, jy, jz)
            term_j = jx * bx + jy * by + jz * bz
            kn = inv_m[..., None] + inv_m[:, j, None, None] + term_i + term_j
        else:
            kn = inv_m[..., None] + term_i
        kn = torch.clamp(kn, min=1e-9)
        slabs.append((_bf16(phi), _bf16(nx), _bf16(ny), _bf16(nz), kn))

    denom = torch.clamp(cnt_i + torch.stack(cnt_j, dim=1), min=1.0)
    return slabs, 1.0 / denom


def _jacobi_iteration(fr: Frame, c: Prepared, slabs, scale_body, vel, inv_dt_b):
    """One Jacobi iteration: every impulse of both channels from the
    velocities at the iteration's start, then all deltas applied."""
    lin, ang, plin, pang = vel
    N = lin.shape[1]
    inv_m, fric = c.body[..., 2], c.body[..., 6]
    envv, envf = c.env[:, 15:18], c.env[:, 18]
    ri = fr.ri
    zl = torch.zeros_like(lin[..., 0])  # (B, N)
    # [real, pseudo] accumulators on i: lin xyz + ang xyz
    acc = [[zl] * 6 for _ in range(2)]
    # [real, pseudo] reactions on the body colliders: lin xyz + ang xyz, per j
    rx = [[[torch.zeros_like(zl[:, 0])] * 6 for _ in range(N)] for _ in range(2)]
    s_i = scale_body * inv_m

    for j, (phi, nx, ny, nz, kn) in enumerate(slabs):
        contact = phi < 0.0
        pen = torch.clamp(-phi, min=0.0)
        bias = inv_dt_b * torch.clamp(pen - SLOP, min=0.0)
        if j < N:
            rj = fr.rj(j)
            mu = fric[..., None] * fric[:, j, None, None]
        else:
            rj = None
            mu = fric[..., None] * envf[j - N]

        def rel_vel(lv, av, ext_j):
            """Relative contact-point velocity of i against j for one channel;
            ``ext_j`` is an env collider's velocity."""
            vx = lv[..., 0, None] + av[..., 1, None] * ri[2] - av[..., 2, None] * ri[1]
            vy = lv[..., 1, None] + av[..., 2, None] * ri[0] - av[..., 0, None] * ri[2]
            vz = lv[..., 2, None] + av[..., 0, None] * ri[1] - av[..., 1, None] * ri[0]
            if j < N:
                lj, aj = lv[:, j, :, None, None], av[:, j, :, None, None]
                vjx = lj[:, 0] + aj[:, 1] * rj[2] - aj[:, 2] * rj[1]
                vjy = lj[:, 1] + aj[:, 2] * rj[0] - aj[:, 0] * rj[2]
                vjz = lj[:, 2] + aj[:, 0] * rj[1] - aj[:, 1] * rj[0]
            else:
                vjx, vjy, vjz = ext_j
            return vx - vjx, vy - vjy, vz - vjz

        def accum(ch, ix, iy, iz):
            dlx, dly, dlz, dax, day, daz = acc[ch]
            dlx = dlx + torch.sum(ix, dim=2) * s_i
            dly = dly + torch.sum(iy, dim=2) * s_i
            dlz = dlz + torch.sum(iz, dim=2) * s_i
            tqx = torch.sum(ri[1] * iz - ri[2] * iy, dim=2)
            tqy = torch.sum(ri[2] * ix - ri[0] * iz, dim=2)
            tqz = torch.sum(ri[0] * iy - ri[1] * ix, dim=2)
            wx, wy, wz = fr.apply_inv_inertia(slice(None), tqx, tqy, tqz)
            acc[ch] = [dlx, dly, dlz, dax + wx * scale_body, day + wy * scale_body,
                       daz + wz * scale_body]
            if j < N:
                # reaction on body j: the impulse is ON i, so -impulse on j
                r = rx[ch][j]
                s_j = scale_body[:, j] * inv_m[:, j]
                tjx = -torch.sum(rj[1] * iz - rj[2] * iy, dim=(1, 2))
                tjy = -torch.sum(rj[2] * ix - rj[0] * iz, dim=(1, 2))
                tjz = -torch.sum(rj[0] * iy - rj[1] * ix, dim=(1, 2))
                bx, by, bz = fr.apply_inv_inertia(j, tjx, tjy, tjz)
                rx[ch][j] = [r[0] - torch.sum(ix, dim=(1, 2)) * s_j,
                             r[1] - torch.sum(iy, dim=(1, 2)) * s_j,
                             r[2] - torch.sum(iz, dim=(1, 2)) * s_j,
                             r[3] + bx * scale_body[:, j],
                             r[4] + by * scale_body[:, j],
                             r[5] + bz * scale_body[:, j]]

        # real channel: normal impulse against the approach only (no bias)
        # and under-relaxed cone-clamped friction
        m = j - N
        rvx, rvy, rvz = rel_vel(lin, ang, None if j < N else (envv[m, 0], envv[m, 1],
                                                              envv[m, 2]))
        v_n = rvx * nx + rvy * ny + rvz * nz
        jn = torch.where(contact, torch.clamp(-v_n / kn, min=0.0), 0.0)
        tx = rvx - v_n * nx
        ty = rvy - v_n * ny
        tz = rvz - v_n * nz
        vt = torch.sqrt(tx * tx + ty * ty + tz * tz + 1e-18)
        jt = torch.minimum(FRICTION_RELAX * vt / kn, mu * jn)
        inv_vt = 1.0 / (vt + 1e-9)
        accum(0, jn * nx - jt * tx * inv_vt, jn * ny - jt * ty * inv_vt,
              jn * nz - jt * tz * inv_vt)

        # pseudo channel: normal only, driven by the bias against the current
        # pseudo velocities (env colliders carry none)
        pvx, pvy, pvz = rel_vel(plin, pang, None if j < N else (0.0, 0.0, 0.0))
        p_n = pvx * nx + pvy * ny + pvz * nz
        jp = torch.where(contact, torch.clamp((-p_n + bias) / kn, min=0.0), 0.0)
        accum(1, jp * nx, jp * ny, jp * nz)

    out = []
    for ch, (lv, av) in enumerate([(lin, ang), (plin, pang)]):
        d = [acc[ch][k] + torch.stack([rx[ch][b][k] for b in range(N)], dim=1)
             for k in range(6)]
        out.append(lv + torch.stack(d[:3], dim=-1))
        out.append(av + torch.stack(d[3:], dim=-1))
    return tuple(out)


def _plain_step(pos, quat, lin, ang, c: Prepared, n_iter, dt, g_dt, inv_dt_b,
                lin_keep, ang_keep):
    dm = c.body[..., 1] > 0  # dynamic bodies (B, N)
    lin = lin + torch.stack([torch.zeros_like(dm, dtype=lin.dtype)] * 2
                            + [torch.where(dm, g_dt, 0.0)], dim=-1)
    fr = Frame(pos, quat, c)
    slabs, scale_body = narrowphase(fr, c)
    vel = (lin, ang, torch.zeros_like(lin), torch.zeros_like(ang))
    for _ in range(n_iter):
        vel = _jacobi_iteration(fr, c, slabs, scale_body, vel, inv_dt_b)
    lin, ang, plin, pang = vel

    # damping, static zeroing, integration
    dm = dm[..., None]
    lin = torch.where(dm, lin * lin_keep, 0.0)
    ang = torch.where(dm, ang * ang_keep, 0.0)
    plin = torch.where(dm, plin, 0.0)
    pang = torch.where(dm, pang, 0.0)
    # positions integrate real + pseudo velocities; only the real ones
    # persist into the next step (split impulse)
    pos = pos + torch.where(dm, (lin + plin) * dt, 0.0)
    o = ang + pang
    qw, qx, qy, qz = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    # dq = [0, o] * quat; quat += 0.5 * dt * dq; normalize
    dqw = -ox * qx - oy * qy - oz * qz
    dqx = ox * qw + oy * qz - oz * qy
    dqy = -ox * qz + oy * qw + oz * qx
    dqz = ox * qy - oy * qx + oz * qw
    nqw = qw + 0.5 * dt * dqw
    nqx = qx + 0.5 * dt * dqx
    nqy = qy + 0.5 * dt * dqy
    nqz = qz + 0.5 * dt * dqz
    inv_n = torch.rsqrt(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz + 1e-12)
    new_quat = torch.stack([nqw * inv_n, nqx * inv_n, nqy * inv_n, nqz * inv_n], dim=-1)
    quat = torch.where(dm, new_quat, quat)
    return pos, quat, lin, ang


def rollout_fused_plain(state: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv,
                        n_steps: int, dt: float = None, gravity: float = -9.8, n_iter: int = 4,
                        linear_damping: float = 0.0095,
                        angular_damping: float = 0.0095) -> SceneState:
    """Plain PyTorch version of :func:`rollout_fused`: the kernel's arithmetic
    over the batch, step by step, bf16 rounding included."""
    dt = DT if dt is None else float(dt)
    c = prepare(state, params, lib, env)
    consts = _step_constants(dt, gravity, linear_damping, angular_damping)
    pos, quat, lin, ang = state.pos, state.quat, state.linvel, state.angvel
    for _ in range(n_steps):
        pos, quat, lin, ang = _plain_step(pos, quat, lin, ang, c, n_iter, dt, *consts)
    return state.replace(pos=pos, quat=quat, linvel=lin, angvel=ang)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


_ARG_POINTERS = ("pos", "quat", "lin", "ang", "active", "shape_id", "scale", "mass", "inertia",
                 "friction", "surf", "types", "ops", "prm", "off", "e_center", "e_half",
                 "e_quat", "e_vel", "e_friction", "e_enabled", "o_pos", "o_quat", "o_lin",
                 "o_ang")
_ARG_INTS = ("N", "P", "S", "M", "K", "n_steps", "n_iter")
_ARG_FLOATS = ("dt", "g_dt", "inv_dt_b", "lin_keep", "ang_keep")


class _RolloutArgs(ctypes.Structure):
    """``RolloutArgs`` of ``csrc/fused_rollout.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _ARG_POINTERS]
                + [(n, ctypes.c_int) for n in _ARG_INTS]
                + [(n, ctypes.c_float) for n in _ARG_FLOATS])


def _library():
    lib = build.load("fused_rollout")
    fn = lib.fused_rollout_launch
    if fn.argtypes is None:  # declare the C signatures once
        fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for f in (lib.fused_rollout_smem_bytes, lib.fused_rollout_blocks_per_sm):
            f.argtypes = [ctypes.c_int] * 4
        lib.fused_rollout_smem_bytes.restype = ctypes.c_longlong
        lib.fused_rollout_blocks_per_sm.restype = ctypes.c_int
    return lib


def kernel_footprint(N: int, P: int, S: int, M: int) -> dict:
    """Shared memory a block of the kernel asks for at these shapes and the
    blocks that fit one SM at once (by registers and shared memory), from the
    built library and the CUDA occupancy calculator."""
    clib = _library()
    return {"threads": -(-N * P // 32) * 32,
            "smem_bytes": int(clib.fused_rollout_smem_bytes(N, P, S, M)),
            "blocks_per_sm": int(clib.fused_rollout_blocks_per_sm(N, P, S, M))}


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype``: itself where it already is."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def rollout_fused(state: SceneState, params: SceneParams, lib: ShapeLib, env: StaticEnv,
                  n_steps: int, dt: float = None, gravity: float = -9.8, n_iter: int = 4,
                  linear_damping: float = 0.0095,
                  angular_damping: float = 0.0095) -> SceneState:
    """``n_steps`` of free-pile physics for every scene of a batch, the state
    on chip for the whole call: the counterpart of ``vmap(engine.rollout)``
    over (B, N, ...) states and parameters (CSG narrowphase), less the
    engine's grip refinements.  Returns the final ``SceneState`` batch."""
    if state.pos.device.type == "cpu":
        return rollout_fused_plain(state, params, lib, env, n_steps, dt, gravity, n_iter,
                                   linear_damping, angular_damping)
    dt = DT if dt is None else float(dt)
    B, N = state.pos.shape[:2]
    P, S, M = lib.surf_pts.shape[1], lib.csg.types.shape[1], env.center.shape[0]
    shapes = f"B={B} scenes, N={N} bodies, P={P} points, S={S} slots, M={M} env boxes"
    for name, t in (("pos", state.pos), ("quat", state.quat), ("linvel", state.linvel),
                    ("angvel", state.angvel)):
        build.check_cuda(t, f"rollout_fused {name}", torch.float32, (B, N, t.shape[-1]))
    if S > MAX_SLOTS or N + M > MAX_COLLIDERS or N * P > MAX_THREADS or N < 1:
        raise ValueError(f"rollout_fused: the kernel takes at most {MAX_SLOTS} CSG slots, "
                         f"{MAX_COLLIDERS} colliders (bodies + env boxes) and {MAX_THREADS} "
                         f"(body, point) pairs a scene; got {shapes}")
    clib = _library()
    smem = int(clib.fused_rollout_smem_bytes(N, P, S, M))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"rollout_fused: a scene's state and contact storage need {smem} bytes "
                         f"of shared memory, over the {MAX_SMEM_BYTES} a block may have; got "
                         f"{shapes}")
    f32, i32 = torch.float32, torch.int32
    out = {f: torch.empty_like(getattr(state, f)) for f in ("pos", "quat", "linvel", "angvel")}
    g_dt, inv_dt_b, lin_keep, ang_keep = _step_constants(dt, gravity, linear_damping,
                                                         angular_damping)
    # every tensor the kernel reads, as the caller holds it (kept alive here
    # until the launch is enqueued)
    tensors = dict(
        pos=state.pos, quat=state.quat, lin=state.linvel, ang=state.angvel,
        active=_as(state.active, torch.bool).view(torch.uint8),
        shape_id=_as(params.shape_id, torch.int64), scale=_as(params.scale, f32),
        mass=_as(params.mass, f32), inertia=_as(params.inertia, f32),
        friction=_as(params.friction, f32), surf=_as(lib.surf_pts, f32),
        types=_as(lib.csg.types, i32), ops=_as(lib.csg.ops, i32), prm=_as(lib.csg.params, f32),
        off=_as(lib.csg.offsets, f32), e_center=_as(env.center, f32), e_half=_as(env.half, f32),
        e_quat=_as(env.quat, f32), e_vel=_as(env.vel, f32), e_friction=_as(env.friction, f32),
        e_enabled=_as(env.enabled, torch.bool).view(torch.uint8),
        o_pos=out["pos"], o_quat=out["quat"], o_lin=out["linvel"], o_ang=out["angvel"])
    for name, t in tensors.items():
        if t.device != state.pos.device:
            raise ValueError(f"rollout_fused {name}: on {t.device}, the state on "
                             f"{state.pos.device}")
    if B > 0:
        args = _RolloutArgs(**{k: t.data_ptr() for k, t in tensors.items()}, N=N, P=P, S=S, M=M,
                            K=lib.surf_pts.shape[0], n_steps=int(n_steps), n_iter=int(n_iter),
                            dt=dt, g_dt=g_dt, inv_dt_b=inv_dt_b, lin_keep=lin_keep,
                            ang_keep=ang_keep)
        status = clib.fused_rollout_launch(
            ctypes.byref(args), B, torch.cuda.current_stream(state.pos.device).cuda_stream)
        build.check_status(status, "rollout_fused")
        rollout_fused.launches += 1
    return state.replace(**out)


rollout_fused.launches = 0
