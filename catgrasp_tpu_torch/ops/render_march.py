"""The renderer's sphere-trace march: CUDA kernel K2 ``march_csg``
(``csrc/march_csg.cu``, the port of the Pallas kernel
``catgrasp_tpu/ops/render_march.py:march_csg``), and its plain PyTorch
versions: the march (the ``lax.scan`` march of
``catgrasp_tpu/render/raymarch.py``, without culling), the per-tile body cull
and the body and env rows that the kernel stages.

``march_csg`` (one scene) and ``march_csg_batch`` (a batch of scenes seen by
one camera, one launch) take the plain march only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise.  On the GPU the kernel is the
renderer's default march.  The kernel reads the scene's tensors as the caller
holds them and does the cull and the staging itself, so a call is one launch
and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import transforms as tf
from ..geom import csg as csglib
from ..sim.engine import StaticEnv, box_sdf_and_normal
from ..sim.types import as_batch
from . import build

TILE = 256  # rays of a strip: the tile of a bare ray set (a 1 x P image)
IMAGE_TILE = (8, 8)  # (rows, columns) of the pixel tile of an image
MAX_BODIES, MAX_ENV = 32, 16  # one warp's lanes stage the bodies, half of another the env boxes
MAX_TILE_RAYS = 256  # rays of a kernel tile: one thread a ray


def scene_sdf(lib, state, params, x: torch.Tensor):
    """φ per body at world points x (..., 3): ((..., N), local points
    (..., N, 3)).  Inactive bodies read 1e9.  A batch of scenes ((B, N,
    ...) state and parameters) takes points (B, ..., 3), each scene's own,
    and gives each scene's values bit for bit as the scene alone."""
    if state.pos.dim() == 2:
        phi, loc = scene_sdf(lib, as_batch(state), as_batch(params), x[None])
        return phi[0], loc[0]
    B, N = state.pos.shape[:2]
    lead = x.shape[1:-1]

    def body(t):  # (B, N, ...) -> (B, 1, ..., 1, N, ...) against x's points
        return t.reshape((B,) + (1,) * len(lead) + t.shape[1:])

    R = tf.quat_to_matrix(state.quat)  # (B,N,3,3)
    rel = x[..., None, :] - body(state.pos)  # (B,...,N,3)
    loc = torch.einsum("sbji,s...bj->s...bi", R, rel) / body(params.scale)[..., None]
    shape = csglib.select_shape(lib.csg, body(params.shape_id))
    phi = csglib.csg_sdf(shape, loc) * body(params.scale)
    return torch.where(body(state.active), phi, 1e9), loc


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
    so the uncapped step never crosses a surface.  One scene ((N, ...) state
    and parameters) gives t (P,); a batch ((B, N, ...)) gives (B, P), all
    its scenes marched together."""
    P = d_w.shape[0]
    lead = tuple(state.pos.shape[:-2])
    t = torch.full(lead + (P,), 0.05, device=d_w.device)
    done = torch.zeros(lead + (P,), dtype=torch.bool, device=d_w.device)
    for _ in range(n_steps):
        x = o_w + t[..., None] * d_w
        phi_b, _ = scene_sdf(lib, state, params, x)
        phi = torch.amin(phi_b, dim=-1)
        if env is not None:
            phi = torch.minimum(phi, env_sdf(env, x))
        step = torch.clamp(phi, min=hit_eps * 0.5)
        newly_done = phi < hit_eps
        t = torch.where(done | newly_done, t, torch.minimum(t + step, tmax))
        done = done | newly_done | (t >= tmax)
    return t


# --------------------------------------------------------------------------
# tiles and the per-tile cull (plain versions of the kernel's block prologue)
# --------------------------------------------------------------------------


def tile_geometry(P: int, hw=None, tile=None):
    """(H, W, rows, columns) of a march's tiles: an (H, W) image in
    ``IMAGE_TILE`` pixel tiles, or a bare ray set as a 1 x P image in 1 x
    ``TILE`` strips; ``tile`` overrides the tile's shape."""
    H, W = (1, P) if hw is None else (int(hw[0]), int(hw[1]))
    if H * W != P:
        raise ValueError(f"march_csg: an {H}x{W} image has {H * W} rays, got {P}")
    th, tw = tile if tile is not None else ((1, TILE) if hw is None else IMAGE_TILE)
    if th < 1 or tw < 1:
        raise ValueError(f"march_csg: tile {th}x{tw}")
    return H, W, int(th), int(tw)


def tile_rays(H: int, W: int, th: int, tw: int, device=None):
    """(ray index (NT, th*tw), valid (NT, th*tw)) of the tiles of an (H, W)
    image in th x tw tiles, row-major over tiles and within a tile; a ragged
    tile at the edge marks the pixels past the image invalid (index 0)."""
    ty, tx = -(-H // th), -(-W // tw)
    r = torch.arange(th * tw, device=device)
    y = torch.arange(ty, device=device)[:, None, None] * th + (r // tw)[None, None]
    x = torch.arange(tx, device=device)[None, :, None] * tw + (r % tw)[None, None]
    valid = (y < H) & (x < W)
    idx = torch.where(valid, y * W + x, 0)
    return idx.reshape(ty * tx, th * tw), valid.reshape(ty * tx, th * tw)


def cull_margin(o_w, d_w, pos, radius_w, hw=None, tile=None):
    """The cone-versus-bounding-sphere test of each tile and body, before
    the slack: (margin (..., NT, N) = cos_u - thresh, inside (..., N)).
    A body is visible to a tile where margin >= -1e-4, or the camera is
    inside its sphere (radius + 1e-3), and it is active.  The cone's axis is
    the normalised sum of the tile's valid ray directions, its half-angle the
    largest angle of one of them to the axis."""
    H, W, th, tw = tile_geometry(d_w.shape[0], hw, tile)
    idx, valid = tile_rays(H, W, th, tw, d_w.device)
    dirs = d_w[idx]  # (NT, R, 3)
    axis = torch.where(valid[..., None], dirs, 0.0).sum(dim=1)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    cos = torch.einsum("tpk,tk->tp", dirs, axis)
    cos_t = torch.amin(torch.where(valid, cos, 2.0), dim=1).clamp(-1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    c = pos - o_w  # (..., N, 3)
    dist = torch.linalg.vector_norm(c, dim=-1)
    r = radius_w + 1e-3
    safe = torch.clamp(dist, min=1e-9)
    sin_b = torch.clamp(r / safe, 0.0, 1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
    cos_u = torch.einsum("tk,...nk->...tn", axis, c / safe[..., None])  # (..., NT, N)
    thresh = cos_t[:, None] * cos_b[..., None, :] - sin_t[:, None] * sin_b[..., None, :]
    return cos_u - thresh, dist <= r


def tile_visibility(o_w, d_w, pos, radius_w, active, hw=None, tile=None):
    """Conservative per-tile cone vs body bounding-sphere test, over the
    tiles ``tile_geometry`` gives.  ``pos`` (..., N, 3), ``radius_w`` and
    ``active`` (..., N).  Returns (visidx (..., NT, N) int32 with the visible
    bodies first, in order; visn (..., NT) int32)."""
    N = pos.shape[-2]
    margin, inside = cull_margin(o_w, d_w, pos, radius_w, hw, tile)
    vis = ((margin >= -1e-4) | inside[..., None, :]) & active[..., None, :]
    key = torch.where(vis, 0, 1) * N + torch.arange(N, device=pos.device)
    order = torch.argsort(key, dim=-1)
    return order.to(torch.int32), vis.sum(dim=-1).to(torch.int32)


def body_rows(lib, state, params):
    """(..., N, 38) f32 [pos, R^T, scale, 1/scale, slot params, slot offsets]
    and (..., N, 8) int32 [slot types, slot ops]: what the kernel stages in
    shared memory for each visible body (there laid out in float4s), in the
    layout of the JAX kernel's tables."""
    lead = state.pos.shape[:-1]
    R = tf.quat_to_matrix(state.quat)
    rt = R.transpose(-1, -2).reshape(lead + (9,))
    sid = params.shape_id
    f = torch.cat([state.pos, rt, params.scale[..., None], (1.0 / params.scale)[..., None],
                   lib.csg.params[sid].reshape(lead + (-1,)),
                   lib.csg.offsets[sid].reshape(lead + (-1,))], dim=-1)
    i = torch.cat([lib.csg.types[sid], lib.csg.ops[sid]], dim=-1)
    return f.float(), i.to(torch.int32)


def env_rows(env):
    """(M, 15) f32 [center, R^T, half]: what the kernel stages for each
    enabled env box (there laid out in float4s)."""
    M = env.center.shape[0]
    ert = tf.quat_to_matrix(env.quat).transpose(1, 2).reshape(M, 9)
    return torch.cat([env.center, ert, env.half], dim=1).float()


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------


class _MarchArgs(ctypes.Structure):
    """``MarchArgs`` of ``csrc/march_csg.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("d_w", "tmax", "o_w")]
                + [("o_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_void_p) for n in (
                    "pos", "quat", "active", "scale", "shape_id", "types", "ops", "prm", "off",
                    "radius", "e_center", "e_quat", "e_half", "e_enabled", "t_out", "cull_idx",
                    "cull_n")]
                + [(n, ctypes.c_int) for n in ("sid64", "P", "H", "W", "th", "tw", "tiles_x",
                                                "n_tiles", "N", "S", "M", "n_steps")]
                + [("hit_eps", ctypes.c_float)])


def _launcher():
    fn = build.load("march_csg").march_csg_launch
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [ctypes.POINTER(_MarchArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _kernel_args(lib, states, params, o_w, d_w, tmax, env, n_steps, hit_eps, hw, tile):
    """Check what the kernel reads (device, dtype, shape, layout; nothing is
    copied or converted) and fill its argument struct, for one scene ((N,
    ...) fields) or a batch ((B, N, ...)); returns (args, the scenes' leading
    shape).  Raises ``ValueError`` on anything the kernel
    cannot take."""
    lead = tuple(states.pos.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"march_csg: one scene or one batch axis, got {tuple(states.pos.shape)}")
    B = lead[0] if lead else 1
    N = states.pos.shape[-2]
    P = d_w.shape[0]
    H, W, th, tw = tile_geometry(P, hw, tile)
    K, S = lib.csg.types.shape
    M = 0 if env is None else env.center.shape[0]
    if N < 1 or N > MAX_BODIES or M > MAX_ENV or S > csglib.MAX_SLOTS or B > 65535 \
            or th * tw > MAX_TILE_RAYS:
        raise ValueError(f"march_csg: the kernel takes 1-{MAX_BODIES} bodies, at most "
                         f"{MAX_ENV} env boxes, {csglib.MAX_SLOTS} CSG slots, 65,535 scenes "
                         f"and {MAX_TILE_RAYS} rays a tile; got {N} bodies, {M} env boxes, "
                         f"{S} slots, {B} scenes, {th}x{tw} tiles")
    f32, i32 = torch.float32, torch.int32
    sid_type = params.shape_id.dtype
    if sid_type not in (torch.int64, i32):
        raise ValueError(f"march_csg shape_id: expected int64 or int32, got {sid_type}")
    scene = lead + (N,)
    checks = [("d_w", d_w, f32, (P, 3)), ("tmax", tmax, f32, (P,)),
              ("pos", states.pos, f32, scene + (3,)), ("quat", states.quat, f32, scene + (4,)),
              ("active", states.active, torch.bool, scene), ("scale", params.scale, f32, scene),
              ("shape_id", params.shape_id, sid_type, scene),
              ("types", lib.csg.types, i32, (K, S)), ("ops", lib.csg.ops, i32, (K, S)),
              ("prm", lib.csg.params, f32, (K, S, 3)), ("off", lib.csg.offsets, f32, (K, S, 3)),
              ("radius", lib.radius, f32, (K,))]
    if env is not None:
        checks += [("e_center", env.center, f32, (M, 3)), ("e_quat", env.quat, f32, (M, 4)),
                   ("e_half", env.half, f32, (M, 3)), ("e_enabled", env.enabled, torch.bool, (M,))]
    dev = d_w.device
    for name, t, dtype, shape in checks:
        build.check_cuda(t, f"march_csg {name}", dtype, shape)
        if t.device != dev:
            raise ValueError(f"march_csg {name}: on {t.device}, the rays on {dev}")
    if o_w.device != dev or o_w.dtype != f32 or o_w.shape != (3,):
        raise ValueError(f"march_csg o_w: expected a (3,) float32 tensor on {dev}, got "
                         f"{tuple(o_w.shape)} {o_w.dtype} on {o_w.device}")
    ptr = {name: t.data_ptr() for name, t, _, _ in checks}
    tiles_x = -(-W // tw)
    args = _MarchArgs(**ptr, o_w=o_w.data_ptr(), o_stride=o_w.stride(0),
                      sid64=int(sid_type == torch.int64), P=P, H=H, W=W, th=th, tw=tw,
                      tiles_x=tiles_x, n_tiles=-(-H // th) * tiles_x, N=N, S=S, M=M,
                      n_steps=int(n_steps), hit_eps=float(hit_eps))
    return args, lead


def _launch(args, B, cull_only, device):
    status = _launcher()(ctypes.byref(args), B, int(cull_only),
                         torch.cuda.current_stream(device).cuda_stream)
    build.check_status(status, "march_csg")


def _march(lib, states, params, o_w, d_w, tmax, env=None, n_steps: int = 64,
           hit_eps: float = 2e-4, hw=None, tile=None):
    """The kernel's launch (CUDA tensors only): t (P,) for one scene, (B, P)
    for a batch.  ``tile`` overrides the tile's shape (at most
    ``MAX_TILE_RAYS`` rays); the tried tiles are measured through it."""
    args, lead = _kernel_args(lib, states, params, o_w, d_w, tmax, env, n_steps, hit_eps, hw,
                              tile)
    t = torch.empty(lead + (args.P,), dtype=torch.float32, device=d_w.device)
    args.t_out = t.data_ptr()
    if t.numel() > 0:
        _launch(args, lead[0] if lead else 1, False, d_w.device)
        march_csg.launches += 1
    return t


def march_csg_batch(lib, states, params, o_w, d_w, tmax, env=None,
                    n_steps: int = 64, hit_eps: float = 2e-4, hw=None) -> torch.Tensor:
    """Sphere-trace the P rays of one camera through every scene of a batch
    ((B, N, ...) states and params); returns t (B, P), in one launch.  ``hw``
    = (H, W) says the rays are an image's pixels in row-major order, which
    the kernel marches in ``IMAGE_TILE`` tiles; without it they are a bare
    ray set, marched in strips of ``TILE``."""
    if states.pos.dim() != 3:
        raise ValueError("march_csg_batch: states and params need a leading scene axis")
    tile_geometry(d_w.shape[0], hw)
    if d_w.device.type == "cpu":
        return march_csg_plain(lib, states, params, o_w, d_w, tmax, env=env,
                               n_steps=n_steps, hit_eps=hit_eps)
    return _march(lib, states, params, o_w, d_w, tmax, env, n_steps, hit_eps, hw)


def march_csg(lib, state, params, o_w, d_w, tmax, env=None,
              n_steps: int = 64, hit_eps: float = 2e-4, hw=None) -> torch.Tensor:
    """Sphere-trace all P rays through one CSG scene ((N, ...) state and
    params); returns t (P,).  The one-scene case of ``march_csg_batch``:
    the same launch with B = 1."""
    if state.pos.dim() != 2:
        raise ValueError("march_csg: one scene's (N, ...) state; march_csg_batch takes batches")
    tile_geometry(d_w.shape[0], hw)
    if d_w.device.type == "cpu":
        return march_csg_plain(lib, state, params, o_w, d_w, tmax, env=env,
                               n_steps=n_steps, hit_eps=hit_eps)
    return _march(lib, state, params, o_w, d_w, tmax, env, n_steps, hit_eps, hw)


march_csg.launches = 0


def tile_visibility_kernel(lib, states, params, o_w, d_w, hw=None, tile=None):
    """The kernel's own cull lists, from a launch of its block prologue alone
    (CUDA tensors only; not counted in ``march_csg.launches``): (visidx (B,
    NT, N) int32, the visible bodies in order and -1 beyond; visn (B, NT))."""
    tmax = torch.empty((d_w.shape[0],), dtype=torch.float32, device=d_w.device)
    args, lead = _kernel_args(lib, states, params, o_w, d_w, tmax, None, 0, 0.0, hw, tile)
    B = lead[0] if lead else 1
    visidx = torch.full((B, args.n_tiles, args.N), -1, dtype=torch.int32, device=d_w.device)
    visn = torch.zeros((B, args.n_tiles), dtype=torch.int32, device=d_w.device)
    args.cull_idx, args.cull_n = visidx.data_ptr(), visn.data_ptr()
    if B > 0 and args.P > 0:
        _launch(args, B, True, d_w.device)
    return visidx, visn
