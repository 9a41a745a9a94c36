"""The renderer's sphere-trace march: CUDA kernel K2 ``march_csg``
(``csrc/march_csg.cu``, the port of the Pallas kernel
``catgrasp_tpu/ops/render_march.py:march_csg``), its per-tile body cull,
and its plain PyTorch version (the ``lax.scan`` march of
``catgrasp_tpu/render/raymarch.py``, without culling).

``march_csg`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  On the GPU it is the renderer's
default march.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import transforms as tf
from ..geom import csg as csglib
from ..sim.engine import StaticEnv, box_sdf_and_normal
from . import build

TILE = 256  # rays per CUDA block, and the unit of the body cull
MAX_BODIES, MAX_ENV = 32, 16  # shared-memory staging limits of the kernel


def scene_sdf(lib, state, params, x: torch.Tensor):
    """φ per body at world points x (..., 3): ((..., N), local points
    (..., N, 3)).  Inactive bodies read 1e9."""
    R = tf.quat_to_matrix(state.quat)  # (N,3,3)
    rel = x[..., None, :] - state.pos  # (...,N,3)
    loc = torch.einsum("bji,...bj->...bi", R, rel) / params.scale[:, None]
    shape = csglib.select_shape(lib.csg, params.shape_id)
    phi = csglib.csg_sdf(shape, loc) * params.scale
    return torch.where(state.active, phi, 1e9), loc


def env_sdf(env: StaticEnv, x: torch.Tensor) -> torch.Tensor:
    """Min φ over the enabled env boxes at world points x (..., 3)."""
    Rm = tf.quat_to_matrix(env.quat)
    rel = x[..., None, :] - env.center
    loc = torch.einsum("mji,...mj->...mi", Rm, rel)
    d, _ = box_sdf_and_normal(loc, env.half)
    d = torch.where(env.enabled, d, 1e9)
    return torch.amin(d, dim=-1)


def march_csg_plain(lib, state, params, o_w, d_w, tmax, env=None,
                    n_steps: int = 64, hit_eps: float = 2e-4) -> torch.Tensor:
    """Plain PyTorch march: every body at every ray for every step, no
    culling.  Analytic CSG distances are exact-or-conservative lower bounds,
    so the uncapped step never crosses a surface."""
    P = d_w.shape[0]
    t = torch.full((P,), 0.05, device=d_w.device)
    done = torch.zeros((P,), dtype=torch.bool, device=d_w.device)
    for _ in range(n_steps):
        x = o_w + t[:, None] * d_w
        phi_b, _ = scene_sdf(lib, state, params, x)
        phi = torch.amin(phi_b, dim=-1)
        if env is not None:
            phi = torch.minimum(phi, env_sdf(env, x))
        step = torch.clamp(phi, min=hit_eps * 0.5)
        newly_done = phi < hit_eps
        t = torch.where(done | newly_done, t, torch.minimum(t + step, tmax))
        done = done | newly_done | (t >= tmax)
    return t


def tile_visibility(o_w, d_w, pos, radius_w, active):
    """Conservative per-tile cone vs body bounding-sphere test over tiles of
    ``TILE`` consecutive rays (``d_w`` padded to a whole number of tiles).
    Returns (visidx (NT, N) int32 with the visible bodies first, in order;
    visn (NT,) int32)."""
    N = pos.shape[0]
    dirs = d_w.reshape(-1, TILE, 3)
    mean = dirs.mean(dim=1)
    mean = mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    cos_t = torch.amin(torch.einsum("tpk,tk->tp", dirs, mean), dim=1).clamp(-1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    c = pos - o_w
    dist = torch.linalg.vector_norm(c, dim=-1)
    r = radius_w + 1e-3
    inside = dist <= r
    safe = torch.clamp(dist, min=1e-9)
    sin_b = torch.clamp(r / safe, 0.0, 1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
    cos_u = mean @ (c / safe[:, None]).T  # (NT, N)
    thresh = cos_t[:, None] * cos_b[None] - sin_t[:, None] * sin_b[None]
    vis = ((cos_u >= thresh - 1e-4) | inside[None]) & active[None]
    key = torch.where(vis, 0, 1) * N + torch.arange(N, device=pos.device)[None]
    order = torch.argsort(key, dim=1)
    return order.to(torch.int32).contiguous(), vis.sum(dim=1).to(torch.int32).contiguous()


def _pack_bodies(lib, state, params):
    """(N, 38) f32 [pos, R^T, scale, 1/scale, slot params, slot offsets] and
    (N, 8) int32 [slot types, slot ops] — the kernel's body table."""
    N = state.pos.shape[0]
    R = tf.quat_to_matrix(state.quat)
    rt = R.transpose(1, 2).reshape(N, 9)
    sid = params.shape_id
    f = torch.cat([state.pos, rt, params.scale[:, None], (1.0 / params.scale)[:, None],
                   lib.csg.params[sid].reshape(N, 12),
                   lib.csg.offsets[sid].reshape(N, 12)], dim=1)
    i = torch.cat([lib.csg.types[sid], lib.csg.ops[sid]], dim=1)
    return f.float().contiguous(), i.to(torch.int32).contiguous()


def _pack_env(env, device):
    if env is None:
        return (torch.zeros((1, 15), device=device),
                torch.zeros((1,), dtype=torch.int32, device=device), 0)
    M = env.center.shape[0]
    ert = tf.quat_to_matrix(env.quat).transpose(1, 2).reshape(M, 9)
    f = torch.cat([env.center, ert, env.half], dim=1).float().contiguous()
    return f, env.enabled.to(torch.int32).contiguous(), M


def _launcher():
    fn = build.load("march_csg").march_csg_launch
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def march_csg(lib, state, params, o_w, d_w, tmax, env=None,
              n_steps: int = 64, hit_eps: float = 2e-4) -> torch.Tensor:
    """Sphere-trace all P rays through the CSG scene; returns t (P,)."""
    if d_w.device.type == "cpu":
        return march_csg_plain(lib, state, params, o_w, d_w, tmax, env=env,
                               n_steps=n_steps, hit_eps=hit_eps)
    P = d_w.shape[0]
    N = state.pos.shape[0]
    if N > MAX_BODIES or (env is not None and env.center.shape[0] > MAX_ENV):
        raise ValueError(f"march_csg: at most {MAX_BODIES} bodies and {MAX_ENV} env boxes")
    build.check_cuda(d_w, "march_csg d_w", torch.float32, (P, 3))
    build.check_cuda(tmax, "march_csg tmax", torch.float32, (P,))
    n_tiles = -(-P // TILE)
    pad = n_tiles * TILE - P
    # pad with copies of the last ray, which leaves the tile cone unchanged;
    # the kernel does not march rays past P
    d_pad = torch.cat([d_w, d_w[-1:].expand(pad, 3)]) if pad else d_w
    radius_w = lib.radius[params.shape_id] * params.scale
    visidx, visn = tile_visibility(o_w, d_pad, state.pos, radius_w, state.active)
    body_f, body_i = _pack_bodies(lib, state, params)
    env_f, env_on, M = _pack_env(env, d_w.device)
    origin = o_w.to(torch.float32).contiguous()
    build.check_cuda(origin, "march_csg origin", torch.float32, (3,))
    t = torch.empty((P,), dtype=torch.float32, device=d_w.device)
    status = _launcher()(d_w.data_ptr(), tmax.data_ptr(), P, origin.data_ptr(),
                         body_f.data_ptr(), body_i.data_ptr(), N,
                         env_f.data_ptr(), env_on.data_ptr(), M,
                         visidx.data_ptr(), visn.data_ptr(), int(n_steps), float(hit_eps),
                         t.data_ptr(), torch.cuda.current_stream(d_w.device).cuda_stream)
    build.check_status(status, "march_csg")
    march_csg.launches += 1
    return t


march_csg.launches = 0
