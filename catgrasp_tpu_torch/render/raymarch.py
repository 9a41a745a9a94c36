"""SDF-raymarch renderer: depth + instance seg + NUNOCS + normals
(``catgrasp_tpu/render/raymarch.py`` in PyTorch).

Sphere tracing with a fixed step budget.  With ``geometry="csg"`` (the
default) the scene is the analytic CSG trees and the march is
``ops.render_march.march_csg_batch``: kernel K2 on the GPU, one launch a
batch of scenes, its plain version on the CPU.  With ``geometry="grid"``
the scene is the library's baked SDF grids (the arbitrary-mesh path) and the
march is ``march_grid``: plain PyTorch on the device by design, since K2
computes CSG only and the JAX package marches grids with its XLA scan, not
with a Pallas kernel.  The label passes (seg, depth, NUNOCS, normals, xyz)
evaluate the scene once more at the converged points.

The data generator's batches carry one camera a scene (its jittered
cameras).  The kernel marches one camera's rays through many scenes, so
``march_frames`` marches such a batch in each camera's own frame: every
scene's bodies are moved into it, and the env boxes join them as one-box
CSG bodies (``camera_frame_scenes``), which one launch then marches along
the shared camera-frame rays.  Distances along a ray do not change under the rigid
motion, so the label passes run in the world frame as for one camera.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import transforms as tf
from ..geom import csg as csglib
from ..geom import sdf as sdflib
from ..ops import render_march as rm
from ..sim.engine import StaticEnv
from ..sim.types import SceneParams, SceneState, ShapeLib, as_batch, index_scenes

HIT_EPS = 2e-4
# a baked grid's trilinear interpolation error can overstate the distance,
# so the grid march caps its step (CSG distances never overstate it)
GRID_STEP_CAP = 0.05


def camera_rays(K: torch.Tensor, cam_in_world: torch.Tensor, H: int, W: int,
                zfar: float = 3.0):
    """Pixel rays of an (H, W) pinhole camera: (origin (3,), world
    directions (P, 3), camera-frame unit directions (P, 3), tmax (P,) capping
    the camera-frame depth at ``zfar``)."""
    dev = cam_in_world.device
    vs = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    us = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    xs = (us - K[0, 2]) / K[0, 0]
    ys = (vs - K[1, 2]) / K[1, 1]
    d_cam = torch.stack([xs * torch.ones_like(ys), ys * torch.ones_like(xs),
                         torch.ones_like(xs * ys)], dim=-1)
    inv_norm = 1.0 / torch.sqrt(torch.sum(d_cam * d_cam, dim=-1, keepdim=True))
    d_cam = (d_cam * inv_norm).reshape(-1, 3)  # unit dirs; z component = inv_norm
    d_w = torch.einsum("ij,pj->pi", cam_in_world[:3, :3], d_cam).contiguous()
    tmax = (zfar / torch.clamp(d_cam[:, 2], min=1e-3)).contiguous()
    return cam_in_world[:3, 3], d_w, d_cam, tmax


def scene_sdf_grid(lib: ShapeLib, state: SceneState, params: SceneParams, x: torch.Tensor):
    """φ per body at world points x (..., 3) through the baked grids:
    ((..., N), local points (..., N, 3)).  Inactive bodies read 1e9."""
    R = tf.quat_to_matrix(state.quat)  # (N,3,3)
    rel = x[..., None, :] - state.pos  # (...,N,3)
    loc = torch.einsum("bji,...bj->...bi", R, rel) / params.scale[:, None]
    phi = sdflib.query_shapes(lib.sdf_values, lib.sdf_lower, lib.sdf_spacing, params.shape_id,
                              loc) * params.scale
    return torch.where(state.active, phi, 1e9), loc


def march_grid(lib: ShapeLib, state: SceneState, params: SceneParams, o_w, d_w, tmax,
               env: StaticEnv | None = None, n_steps: int = 64,
               hit_eps: float = HIT_EPS) -> torch.Tensor:
    """The march through one scene's baked grids: every body at every ray
    for every step, each step at most ``GRID_STEP_CAP``.  Returns t (P,)."""
    if lib.sdf_values is None:
        raise ValueError("geometry='grid' needs a library built with bake_grids=True")
    P = d_w.shape[0]
    t = torch.full((P,), 0.05, device=d_w.device)
    done = torch.zeros((P,), dtype=torch.bool, device=d_w.device)
    for _ in range(n_steps):
        x = o_w + t[:, None] * d_w
        phi = torch.amin(scene_sdf_grid(lib, state, params, x)[0], dim=-1)
        if env is not None:
            phi = torch.minimum(phi, rm.env_sdf(env, x))
        step = torch.clamp(phi, hit_eps * 0.5, GRID_STEP_CAP)
        newly_done = phi < hit_eps
        t = torch.where(done | newly_done, t, torch.minimum(t + step, tmax))
        done = done | newly_done | (t >= tmax)
    return t


def render(lib: ShapeLib, state: SceneState, params: SceneParams,
           K: torch.Tensor, cam_in_world: torch.Tensor, H: int, W: int,
           env: StaticEnv | None = None, zfar: float = 3.0,
           n_steps: int = 64, with_env: bool = True, geometry: str = "csg"):
    """Render one scene -> dict of (H, W[, C]) images:
    depth (z in cam frame, 0 = invalid), seg (int32: body index, -2 env,
    -1 background), nocs (NUNOCS coords in [0,1], 0 outside objects),
    normal (cam frame, oriented toward the camera), xyz (cam frame), rgb.
    ``geometry`` is "csg" or "grid" (the library's baked SDF grids).
    The one-scene case of ``render_batch``."""
    out = render_batch(lib, as_batch(state), as_batch(params), K, cam_in_world, H, W, env=env,
                       zfar=zfar, n_steps=n_steps, with_env=with_env, geometry=geometry)
    return {k: v[0] for k, v in out.items()}


def shade(lib: ShapeLib, state: SceneState, params: SceneParams,
          cam_in_world: torch.Tensor, H: int, W: int, env: StaticEnv | None,
          d_w: torch.Tensor, d_cam: torch.Tensor, tmax: torch.Tensor,
          t: torch.Tensor, geometry: str = "csg") -> dict:
    """The label passes at the marched ray lengths ``t``: one more scene
    evaluation at the converged points gives seg, depth, NUNOCS, normals,
    the organized cloud and a flat-shaded rgb."""
    dev = t.device
    P = d_w.shape[0]
    o_w = cam_in_world[:3, 3]
    x = o_w + t[:, None] * d_w
    grid = geometry == "grid"
    phi_b, loc = (scene_sdf_grid if grid else rm.scene_sdf)(lib, state, params, x)
    phi_min, body = torch.min(phi_b, dim=-1)
    phi_env = rm.env_sdf(env, x) if env is not None else torch.full((P,), 1e9, device=dev)

    hit_body = (phi_min < HIT_EPS * 4) & (t < tmax)
    hit_env = (phi_env < HIT_EPS * 4) & (phi_env < phi_min) & (t < tmax)
    seg = torch.where(hit_body & ~hit_env, body,
                      torch.where(hit_env, -2, -1)).to(torch.int32)

    # depth = z in camera frame
    z_cam = t * d_cam[:, 2]
    depth = torch.where(seg != -1, z_cam, 0.0)

    # NUNOCS: hit point in the winning body's normalized unit-scale bbox
    loc_win = torch.take_along_dim(loc, body[:, None, None].expand(P, 1, 3), dim=1)[:, 0]
    sid_win = params.shape_id[body]
    b = lib.bounds[sid_win]  # (P,2,3)
    nocs = (loc_win - b[:, 0]) / torch.clamp(b[:, 1] - b[:, 0], min=1e-9)
    nocs = torch.where((seg >= 0)[:, None], torch.clamp(nocs, 0.0, 1.0), 0.0)

    # world normal from the winning body's gradient (CSG: one primitive
    # stack per pixel; grid: one 8-corner fetch), not the all-bodies pass
    if grid:
        _, n_loc_win = sdflib.query_and_grad_shapes(lib.sdf_values, lib.sdf_lower,
                                                    lib.sdf_spacing, sid_win, loc_win)
    else:
        _, n_loc_win = csglib.csg_sdf_and_normal(csglib.select_shape(lib.csg, sid_win),
                                                 loc_win)
    R_win = tf.quat_to_matrix(state.quat)[body]  # (P,3,3)
    normal = torch.einsum("pij,pj->pi", R_win, n_loc_win)
    # camera frame, oriented toward the camera
    T_cw = tf.pose_inverse(cam_in_world)
    normal = torch.einsum("ij,nj->ni", T_cw[:3, :3], normal)
    flip = torch.sign(-torch.sum(normal * d_cam, dim=-1, keepdim=True))
    normal = normal * torch.where(flip == 0, 1.0, flip)
    normal = torch.where((seg >= 0)[:, None], normal, 0.0)

    # xyz in cam frame (organized cloud)
    xyz_cam = tf.transform_points(T_cw, x)
    xyz_cam = torch.where((seg != -1)[:, None], xyz_cam, 0.0)

    # rgb: headlight Lambertian over a per-body albedo palette
    palette = torch.tensor([[0.85, 0.55, 0.35], [0.40, 0.65, 0.85],
                            [0.55, 0.80, 0.45], [0.85, 0.75, 0.35],
                            [0.70, 0.45, 0.75], [0.50, 0.50, 0.50]], device=dev)
    albedo = palette[torch.abs(body) % len(palette)]
    albedo = torch.where((seg == -2)[:, None], 0.35, albedo)
    lambert = torch.clamp(-torch.sum(normal * d_cam, dim=-1), 0.0, 1.0)
    rgb = albedo * (0.25 + 0.75 * lambert[:, None])
    rgb = torch.where((seg != -1)[:, None], rgb, 0.0)

    shp = (H, W)
    return {
        "rgb": rgb.reshape(shp + (3,)),
        "depth": depth.reshape(shp),
        "seg": seg.reshape(shp),
        "nocs": nocs.reshape(shp + (3,)),
        "normal": normal.reshape(shp + (3,)),
        "xyz": xyz_cam.reshape(shp + (3,)),
    }


def render_batch(lib: ShapeLib, states: SceneState, params: SceneParams, K, cam_in_world,
                 H: int, W: int, env: StaticEnv | None = None,
                 scene_chunk: int | None = None, zfar: float = 3.0, n_steps: int = 64,
                 with_env: bool = True, geometry: str = "csg") -> dict:
    """Render a scene batch (leading axis of states/params) -> dict of
    (B, H, W[, C]) images, as ``render`` gives them for each scene.

    With CSG geometry the whole batch is marched in one launch
    (``march_csg_batch``), as the JAX package vmaps it into one
    ``pallas_call``; grid geometry marches scene by scene (``march_grid``).
    The label passes then run scene by scene, so their peak memory is one
    frame's whatever the batch.  ``scene_chunk`` keeps the JAX signature,
    where it bounds memory by running sub-batches in sequence; it must
    divide the batch and changes nothing else here."""
    if geometry not in ("csg", "grid"):
        raise ValueError(f"geometry must be 'csg' or 'grid', got {geometry!r}")
    B = states.pos.shape[0]
    if scene_chunk is not None and scene_chunk < B and B % scene_chunk:
        raise ValueError(f"scene_chunk {scene_chunk} must divide batch {B}")
    dev = states.pos.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    cam_in_world = torch.as_tensor(cam_in_world, dtype=torch.float32, device=dev)
    env = env if (with_env and env is not None) else None
    o_w, d_w, d_cam, tmax = camera_rays(K, cam_in_world, H, W, zfar)
    if geometry == "grid":
        t = [march_grid(lib, index_scenes(states, b), index_scenes(params, b), o_w, d_w, tmax,
                        env=env, n_steps=n_steps) for b in range(B)]
    else:
        t = rm.march_csg_batch(lib, states, params, o_w, d_w, tmax, env=env, n_steps=n_steps,
                               hit_eps=HIT_EPS, hw=(H, W))
    outs = [shade(lib, index_scenes(states, b), index_scenes(params, b), cam_in_world, H, W,
                  env, d_w, d_cam, tmax, t[b], geometry) for b in range(B)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def render_chunked(lib: ShapeLib, state: SceneState, params: SceneParams, K, cam_in_world,
                   H: int, W: int, env: StaticEnv | None = None, rows_per_chunk: int = 256,
                   **kw) -> dict:
    """``render`` in row strips of ``rows_per_chunk``: the label passes'
    memory is bounded by a strip (a full-resolution frame of the reference
    camera, 1544x2064, is 3.2 M rays).  A strip renders the frame's own
    pixel rays by shifting the principal point cy by the strip's first row;
    the last strip is padded back to ``rows`` rows and cropped, as the JAX
    package does it.  Each strip is one march (one K2 launch on the GPU);
    on the CPU the output equals ``render``'s bit for bit."""
    rows = min(rows_per_chunk, H)
    K = torch.as_tensor(K, dtype=torch.float32, device=state.pos.device)
    outs = []
    for r0 in range(0, H, rows):
        crop = 0
        if min(rows, H - r0) != rows:  # pad the last strip, crop after
            r0 = H - rows
            crop = rows - (H - len(outs) * rows)
        Ks = K.clone()
        Ks[1, 2] -= float(r0)
        o = render(lib, state, params, Ks, cam_in_world, rows, W, env=env, **kw)
        outs.append({k: v[crop:] for k, v in o.items()})
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


# --------------------------------------------------------------------------
# a camera a scene: the march in the cameras' frames
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MarchLib:
    """What the march reads of a shape library: the CSG trees and the
    bounding radii."""

    csg: csglib.CsgShape
    radius: torch.Tensor


def with_env_shapes(lib: ShapeLib, env: StaticEnv) -> MarchLib:
    """The library's CSG trees and radii with one shape appended per env
    box: a single BOX slot of the box's half extents at the shape's origin,
    which evaluates the box's distance as the march's env term does.  Shape
    ``lib.num_shapes + m`` is env box ``m``."""
    M, S = env.center.shape[0], lib.csg.types.shape[-1]
    dev = lib.device
    types = torch.full((M, S), csglib.NONE, dtype=torch.int32, device=dev)
    types[:, 0] = csglib.BOX
    prm = torch.zeros((M, S, 3), device=dev)
    prm[:, 0] = env.half
    csg = csglib.CsgShape(types=torch.cat([lib.csg.types, types]),
                          ops=torch.cat([lib.csg.ops, torch.ones_like(types)]),
                          params=torch.cat([lib.csg.params, prm]),
                          offsets=torch.cat([lib.csg.offsets, torch.zeros_like(prm)]))
    radius = torch.cat([lib.radius, torch.linalg.vector_norm(env.half, dim=-1)])
    return MarchLib(csg=csg, radius=radius.contiguous())


def camera_frame_scenes(lib: ShapeLib, states: SceneState, params: SceneParams,
                        cams: torch.Tensor, env: StaticEnv | None = None):
    """(march library, states, params) of a batch of scenes (B, N, ...) seen
    by one camera each (B, 4, 4), moved into each camera's frame.  With an
    env its M boxes follow the N bodies in every scene as bodies of scale 1
    (shapes from ``with_env_shapes``), active where the box is enabled."""
    T_cw = tf.pose_inverse(cams)
    R, t = T_cw[:, :3, :3], T_cw[:, :3, 3]
    q_cw = tf.matrix_to_quat(R)[:, None]
    pos = torch.einsum("bij,bnj->bni", R, states.pos) + t[:, None]
    quat = tf.quat_mul(q_cw.expand_as(states.quat), states.quat)
    active, sid, scale = states.active, params.shape_id, params.scale
    mlib = MarchLib(csg=lib.csg, radius=lib.radius)
    if env is not None:
        B, M = states.pos.shape[0], env.center.shape[0]
        mlib = with_env_shapes(lib, env)
        pos = torch.cat([pos, torch.einsum("bij,mj->bmi", R, env.center) + t[:, None]], dim=1)
        quat = torch.cat([quat, tf.quat_mul(q_cw.expand(B, M, 4), env.quat.expand(B, M, 4))],
                         dim=1)
        active = torch.cat([active, env.enabled.expand(B, M)], dim=1)
        sid = torch.cat([sid, (lib.num_shapes + torch.arange(M, device=sid.device)).expand(B, M)],
                        dim=1)
        scale = torch.cat([scale, torch.ones((B, M), device=scale.device)], dim=1)
    zeros = torch.zeros_like(pos)
    st = SceneState(pos=pos.contiguous(), quat=quat.contiguous(), linvel=zeros, angvel=zeros,
                    active=active.contiguous())
    par = SceneParams(shape_id=sid.contiguous(), scale=scale.contiguous(),
                      mass=torch.ones_like(scale), inertia=torch.ones_like(pos),
                      friction=torch.ones_like(scale))
    return mlib, st, par


def march_frames(lib: ShapeLib, states: SceneState, params: SceneParams, K: torch.Tensor,
                 cams: torch.Tensor, H: int, W: int, env: StaticEnv | None = None,
                 zfar: float = 3.0, n_steps: int = 64):
    """March B scenes, each through its own camera's (H, W) pixel rays, in
    one ``march_csg_batch`` call (one K2 launch on the GPU): (t (B, P), the
    camera-frame unit directions (P, 3), tmax (P,)).  ``env`` as
    ``camera_frame_scenes`` takes it."""
    eye = torch.eye(4, device=states.pos.device)
    o, d_cam, _, tmax = camera_rays(K, eye, H, W, zfar)
    mlib, st, par = camera_frame_scenes(lib, states, params, cams, env)
    t = rm.march_csg_batch(mlib, st, par, torch.zeros_like(o), d_cam, tmax, n_steps=n_steps,
                           hit_eps=HIT_EPS, hw=(H, W))
    return t, d_cam, tmax


def shade_frames(lib: ShapeLib, states: SceneState, params: SceneParams, cams: torch.Tensor,
                 H: int, W: int, env: StaticEnv | None, d_cam: torch.Tensor, tmax: torch.Tensor,
                 t: torch.Tensor) -> dict:
    """The label passes of B scenes marched by ``march_frames`` (t (B, P)),
    each in the world frame of its own camera (B, 4, 4), scene by scene:
    dict of (B, H, W[, C]) images."""
    outs = [shade(lib, index_scenes(states, b), index_scenes(params, b), cams[b], H, W, env,
                  d_cam @ cams[b, :3, :3].T, d_cam, tmax, t[b]) for b in range(t.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _body_phi(lib: ShapeLib, pos, quat, scale, shape_id, x):
    """φ of one body a row of points, broadcasting: pos (..., 3), quat (...,
    4), scale and shape_id (...), x (..., 3) -> (...)."""
    R = tf.quat_to_matrix(quat)
    loc = (R.transpose(-1, -2) @ (x - pos)[..., None])[..., 0] / scale[..., None]
    return csglib.csg_sdf(csglib.select_shape(lib.csg, shape_id), loc) * scale


def visibility_scenes(states: SceneState, params: SceneParams, cams: torch.Tensor):
    """The frames of ``visibility_counts`` as one batch of B (N + 1) scenes:
    scene b's full frame, then its N solo frames (only body i active), each
    with scene b's camera.  Returns (states, params, cameras)."""
    dev = states.pos.device
    B, N = states.active.shape
    solo = states.active[:, :, None] & torch.eye(N, dtype=torch.bool, device=dev)
    active = torch.cat([states.active[:, None], solo], dim=1).reshape(B * (N + 1), N)

    def rep(x):
        return x[:, None].expand(B, N + 1, *x.shape[1:]).reshape(B * (N + 1), *x.shape[1:])

    st = SceneState(pos=rep(states.pos), quat=rep(states.quat), linvel=rep(states.linvel),
                    angvel=rep(states.angvel), active=active)
    par = SceneParams(shape_id=rep(params.shape_id), scale=rep(params.scale),
                      mass=rep(params.mass), inertia=rep(params.inertia),
                      friction=rep(params.friction))
    return st, par, rep(cams)


def pixel_counts(lib: ShapeLib, states: SceneState, params: SceneParams, cams: torch.Tensor,
                 d_cam: torch.Tensor, tmax: torch.Tensor, t: torch.Tensor):
    """Each body's pixels in the frames of ``visibility_scenes`` marched to
    ``t`` (B (N + 1), P): ((B, N) in the full frames, (B, N) alone).  A
    body's pixel, as ``shade``'s seg has it: the body is the nearest active
    one within 4 hit_eps of the converged point and the ray stopped short of
    tmax."""
    B, N = states.active.shape
    t = t.reshape(B, N + 1, -1)
    d_w = torch.einsum("bij,pj->bpi", cams[:, :3, :3], d_cam)  # (B, P, 3)
    x = cams[:, None, None, :3, 3] + t[..., None] * d_w[:, None]  # (B, N + 1, P, 3)
    short = t < tmax
    # full frames: the nearest active body at each converged point
    phi_min, body = torch.min(rm.scene_sdf(lib, states, params, x[:, 0])[0], dim=-1)
    hit = (phi_min < HIT_EPS * 4) & short[:, 0]
    full = (torch.nn.functional.one_hot(body, N) * hit[..., None]).sum(dim=1)
    # solo frames: body i alone
    phi_i = _body_phi(lib, states.pos[:, :, None], states.quat[:, :, None],
                      params.scale[:, :, None], params.shape_id[:, :, None], x[:, 1:])
    alone = ((phi_i < HIT_EPS * 4) & short[:, 1:] & states.active[..., None]).sum(dim=-1)
    return full, alone


def visibility_counts(lib: ShapeLib, states: SceneState, params: SceneParams, K, cams,
                      H: int, W: int, zfar: float = 3.0, n_steps: int = 64):
    """Each body's pixel count in its scene's (H, W) frame and alone: ((B,
    N), (B, N)).  The B full frames and the B x N solo frames are marched
    with no env boxes, as the data generator calls JAX's
    ``visibility_ratio`` (the bin never occludes in this label), as one
    batch of B (N + 1) scenes in one ``march_frames`` call (one K2 launch
    on the GPU)."""
    dev = states.pos.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    cams = torch.as_tensor(cams, dtype=torch.float32, device=dev)
    st, par, cams_r = visibility_scenes(states, params, cams)
    t, d_cam, tmax = march_frames(lib, st, par, K, cams_r, H, W, zfar=zfar, n_steps=n_steps)
    return pixel_counts(lib, states, params, cams, d_cam, tmax, t)


def visibility_ratio_batch(lib: ShapeLib, states: SceneState, params: SceneParams, K, cams,
                           H: int, W: int, **kw) -> torch.Tensor:
    """Per-body visibility (B, N): pixels visible in the full scene / pixels
    visible alone, the occlusion-ratio label of the reference's
    ``tool.py:229-275``, over ``visibility_counts``."""
    full, alone = visibility_counts(lib, states, params, K, cams, H, W, **kw)
    return full.float() / torch.clamp(alone, min=1).float()


def visibility_ratio(lib: ShapeLib, state: SceneState, params: SceneParams, K, cam_in_world,
                     H: int, W: int, **kw) -> torch.Tensor:
    """One scene's per-body visibility (N,): the one-scene case of
    ``visibility_ratio_batch``."""
    cam = torch.as_tensor(cam_in_world, dtype=torch.float32, device=state.pos.device)
    return visibility_ratio_batch(lib, as_batch(state), as_batch(params), K, cam[None], H, W,
                                  **kw)[0]
