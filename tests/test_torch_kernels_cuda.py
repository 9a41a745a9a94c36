"""The CUDA kernels against their plain PyTorch versions, on the GPU.

CUDA kernels have no CPU mode, so every test here skips on a host without a
GPU.  The file imports nothing of JAX, so it runs on a GPU machine without
it (nor does ``tests/test_torch_isolation.py``):
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py tests/test_torch_isolation.py``.
"""
import numpy as np
import pytest
import torch

from catgrasp_tpu_torch.geom import csg, primitives
from catgrasp_tpu_torch.grasp import filter as gfilter
from catgrasp_tpu_torch.ops import collision, fused_rollout, render_march
from catgrasp_tpu_torch.render import raymarch
from catgrasp_tpu_torch.sim import engine, env_pile
from catgrasp_tpu_torch.sim.env_grasp import GripperSpec
from catgrasp_tpu_torch.sim.types import (SceneParams, SceneState, as_batch, build_shape_lib,
                                          index_scenes)

torch.set_num_threads(2)
OFFSETS = tuple(float(o) for o in gfilter.ADJUST_OFFSETS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_box_hits_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    n, c = 3001, 2500  # ragged against the pose blocks and the point chunks
    q = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    T = torch.zeros((n, 4, 4))
    from catgrasp_tpu_torch.core import transforms as tf
    T[:, :3, :3] = tf.quat_to_matrix(q)
    T[:, :3, 3] = torch.from_numpy(rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32))
    T[:, 3, 3] = 1.0
    t_inv = collision.pose_inverse_batch(T.to(dev)).contiguous()
    cloud = torch.from_numpy(rng.uniform(-0.3, 0.3, (c, 3)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(size=c) > 0.2).to(dev)
    for boxes in (gfilter._static_open_boxes(GripperSpec()),
                  gfilter._static_enclosed_box(GripperSpec(), 0.002)):
        n0 = collision.box_hits.launches
        k = collision.box_hits(t_inv, cloud, mask, boxes, OFFSETS, 5e-4)
        p = collision.box_hits_plain(t_inv, cloud, mask, boxes, OFFSETS, 5e-4)
        torch.cuda.synchronize()
        assert collision.box_hits.launches == n0 + 1
        assert 0 < int(p.sum()) < p.numel()
        assert (k != p).float().mean().item() <= 1e-5


def test_box_hits_rejects_bad_inputs(dev):
    t_inv = torch.eye(4, device=dev)[None]
    cloud = torch.zeros((2, 3), device=dev)
    mask = torch.ones(2, dtype=torch.bool, device=dev)
    boxes = (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),)
    with pytest.raises(ValueError):
        collision.box_hits(t_inv, cloud.double(), mask, boxes, (0.0,), 5e-4)
    with pytest.raises(ValueError):
        collision.box_hits(t_inv, cloud[:, :2], mask, boxes, (0.0,), 5e-4)
    # at most 4 boxes, 8 offsets and 4 depths
    with pytest.raises(ValueError, match="9 offsets"):
        collision.box_hits(t_inv, cloud, mask, boxes, tuple([0.0] * 9), 5e-4)
    with pytest.raises(ValueError, match="5 boxes"):
        collision.box_hits(t_inv, cloud, mask, boxes * 5, (0.0,), 5e-4)
    with pytest.raises(ValueError, match="5 depths"):
        collision.box_hits_depths(t_inv, cloud, mask, boxes, (0.0,), tuple([0.0] * 5), 5e-4)


@pytest.mark.parametrize("which,n_offsets,n_depths", [
    *((w, a, d) for w in ("open", "enclosed") for a in (1, 7) for d in (1, 4)),  # compiled counts
    ("open", 3, 2), ("enclosed", 3, 2), ("both", 8, 4),  # run-time counts; every bit of the mask
])
def test_box_hits_every_variant_matches_plain_exactly(dev, which, n_offsets, n_depths):
    """Each (boxes, offsets, depths) variant compiled with its counts, and
    counts that take the variant with run-time counts (up to the most: 4
    boxes x 8 offsets x 4 depths), on a case ragged against the pose blocks
    and the 128-point chunks, with all-hit and none-hit poses, and an
    all-masked cloud."""
    rng = np.random.default_rng(5)
    n, c = 3001, 2500
    q = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    T = torch.zeros((n, 4, 4))
    from catgrasp_tpu_torch.core import transforms as tf
    T[:, :3, :3] = tf.quat_to_matrix(q)
    T[:, :3, 3] = torch.from_numpy(rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32))
    T[:40, :3, 3] = 5.0  # none-hit poses
    T[:, 3, 3] = 1.0
    t_inv = collision.pose_inverse_batch(T.to(dev)).contiguous()
    pts = rng.uniform(-0.3, 0.3, (c, 3)).astype(np.float32)
    pts[:1500] = rng.uniform(-0.04, 0.04, (1500, 3))  # dense at the origin: all-hit poses
    cloud = torch.from_numpy(pts).to(dev)
    mask = torch.from_numpy(rng.uniform(size=c) > 0.2).to(dev)
    spec = GripperSpec()
    boxes = {"open": gfilter._static_open_boxes(spec),
             "enclosed": gfilter._static_enclosed_box(spec),
             "both": gfilter._static_open_boxes(spec) + gfilter._static_enclosed_box(spec)}[which]
    offsets = (OFFSETS + (4e-3,))[:n_offsets]
    depths = tuple(float(d) for d in gfilter.DEPTH_OFFSETS[:n_depths])
    n0 = collision.box_hits.launches
    k = collision.box_hits_depths(t_inv, cloud, mask, boxes, offsets, depths, 5e-4)
    p = collision.box_hits_depths_plain(t_inv, cloud, mask, boxes, offsets, depths, 5e-4)
    torch.cuda.synchronize()
    assert collision.box_hits.launches == n0 + 1
    assert k.shape == (n, n_depths, n_offsets) and k.dtype == torch.bool
    assert torch.equal(k, p)
    assert not p[:40].any() and p.all(dim=2).all(dim=1).any() and 0 < int(p.sum()) < p.numel()
    none = torch.zeros_like(mask)
    assert not collision.box_hits_depths(t_inv, cloud, none, boxes, offsets, depths, 5e-4).any()


def test_box_hits_on_the_nocs_gate(dev):
    """K1 at the NOCS-transfer gate's own shapes: the nut canonical's 5,679
    codebook grasps (score >= 0.95) x 12 symmetries = 68,148 poses under a
    NUNOCS pose in view, the open gripper against 512 target points and the
    closing volume against 4,096 floor points, 7 offsets x 4 depths: at most
    1e-5 of the entries differ from the plain version."""
    import os
    from catgrasp_tpu_torch.core.symmetry import get_symmetry_tfs
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    can = np.load(os.path.join(repo, "dataset", "nut_canonical.npz"))
    grasps = can["canonical_grasps"][can["canonical_grasp_scores"] >= 0.95]
    nocs_pose = np.eye(4, dtype=np.float32)
    nocs_pose[:3, :3] = np.diag([0.024, -0.024, -0.008]).astype(np.float32)
    nocs_pose[:3, 3] = [0.0, 0.0, 0.69]
    rng = np.random.default_rng(9)
    target = can["canonical_cloud"][rng.choice(1024, 512, replace=False)] @ nocs_pose[:3, :3].T \
        + nocs_pose[:3, 3]
    floor = rng.uniform([-0.1, -0.1, 0.7], [0.1, 0.1, 0.72], (4096, 3))
    sym = torch.from_numpy(get_symmetry_tfs("nut")).to(dev)
    T = torch.einsum("sij,gjk->gsik", sym, torch.from_numpy(grasps).to(dev))
    T = torch.einsum("ij,gsjk->gsik", torch.from_numpy(nocs_pose).to(dev), T).reshape(-1, 4, 4)
    R = T[:, :3, :3] / torch.linalg.vector_norm(T[:, :3, :3], dim=1, keepdim=True)
    T = torch.cat([torch.cat([R, T[:, :3, 3:]], dim=2), T[:, 3:]], dim=1)
    assert T.shape[0] == 68_148
    t_inv = collision.pose_inverse_batch(T).contiguous()
    depths = tuple(float(d) for d in gfilter.DEPTH_OFFSETS)
    spec = GripperSpec()
    for boxes, pts in ((gfilter._static_open_boxes(spec), target),
                       (gfilter._static_enclosed_box(spec), floor)):
        cloud = torch.from_numpy(pts.astype(np.float32)).to(dev)
        mask = torch.ones(len(pts), dtype=torch.bool, device=dev)
        k = collision.box_hits_depths(t_inv, cloud, mask, boxes, OFFSETS, depths, 5e-4)
        p = collision.box_hits_depths_plain(t_inv, cloud, mask, boxes, OFFSETS, depths, 5e-4)
        torch.cuda.synchronize()
        assert k.shape == (68_148, 4, 7) and 0 < int(p.sum()) < p.numel()
        assert (k != p).float().mean().item() <= 1e-5


def test_box_hits_on_the_grasp_db_gate(dev):
    """K1 at the grasp DB's collision gate: the cone sampler's 100 x 61 x 7
    = 42,700 poses on a nut's 200 surface points at ``config_grasp.yml``'s
    settings, the open gripper against those 200 points and the closing
    volume against one point at infinity, 7 offsets, 1 depth: at most 1e-5
    of the entries differ from the plain version."""
    from catgrasp_tpu_torch.grasp.gripper import Gripper
    from catgrasp_tpu_torch.grasp.sampler import PointConeGraspSampler
    mesh = primitives.make_instance("nut", "train", 0)
    pts, nrm = mesh.sample_surface(200, np.random.default_rng(0), return_normals=True)
    cloud = torch.from_numpy(pts).to(dev)
    sampler = PointConeGraspSampler(Gripper.default(), max_num_samples=100, n_sphere_dir=10,
                                    approach_step=0.006)
    T = sampler.sample_grasp_poses(cloud, torch.from_numpy(nrm).to(dev),
                                   torch.Generator(device=dev).manual_seed(0))
    assert T.shape == (42_700, 4, 4)
    t_inv = collision.pose_inverse_batch(T).contiguous()
    spec = GripperSpec()
    far = torch.full((1, 3), 999.0, device=dev)
    for boxes, c in ((gfilter._static_open_boxes(spec), cloud),
                     (gfilter._static_enclosed_box(spec), far)):
        mask = torch.ones(len(c), dtype=torch.bool, device=dev)
        k = collision.box_hits_depths(t_inv, c, mask, boxes, OFFSETS, (0.0,), 5e-4)
        p = collision.box_hits_depths_plain(t_inv, c, mask, boxes, OFFSETS, (0.0,), 5e-4)
        torch.cuda.synchronize()
        assert k.shape == (42_700, 1, 7)
        assert (k != p).float().mean().item() <= 1e-5
        assert (int(p.sum()) > 0) == (c is cloud)


def _march_scene(dev):
    classes = ("nut", "screw", "hnm")
    lib = build_shape_lib([primitives.make_instance(c, "train", 0) for c in classes],
                          [csg.make_csg_instance(c, "train", 0) for c in classes],
                          n_surf=16, device=dev)
    params = SceneParams.create(lib, [0, 1, 2], [1.0, 1.1, 0.9])
    state = SceneState.create(3, device=dev)
    state.pos[:] = torch.tensor([[0.0, 0.0, 0.02], [0.04, 0.02, 0.03], [-0.04, -0.03, 0.025]])
    state.quat[:] = torch.tensor([[1.0, 0, 0, 0], [0.9238795, 0.3826834, 0, 0],
                                  [0.9238795, 0, 0.3826834, 0]])
    state.active[:] = True
    env = engine.StaticEnv.open_bin((0.18, 0.18, 0.08), device=dev)
    return lib, state, params, env


def _top_camera(dev, H, W, f, z=0.3):
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], device=dev)
    cam = torch.eye(4, device=dev)
    cam[:3, :3] = torch.tensor([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    cam[2, 3] = z
    return K, cam


def _frames_agree(lib, state, params, cam, H, W, env, d_w, d_cam, tmax, t_k, t_p):
    out_k = raymarch.shade(lib, state, params, cam, H, W, env, d_w, d_cam, tmax, t_k)
    out_p = raymarch.shade(lib, state, params, cam, H, W, env, d_w, d_cam, tmax, t_p)
    agree = (out_k["seg"] == out_p["seg"]).float().mean().item()
    assert agree > 0.995
    both = (out_k["seg"] == out_p["seg"]) & (out_p["seg"] != -1)
    if both.any():
        assert (out_k["depth"] - out_p["depth"])[both].abs().max().item() < 2e-3
    assert set(out_k["seg"].unique().tolist()) == set(out_p["seg"].unique().tolist())
    return out_k["seg"]


def test_march_kernel_matches_plain(dev):
    lib, state, params, env = _march_scene(dev)
    H, W = 100, 300  # 30,000 rays: ragged strips and ragged 8x8 tiles
    K, cam = _top_camera(dev, H, W, 250.0)
    o_w, d_w, d_cam, tmax = raymarch.camera_rays(K, cam, H, W)
    for e in (env, None):
        for hw in (None, (H, W)):
            n0 = render_march.march_csg.launches
            t_k = render_march.march_csg(lib, state, params, o_w, d_w, tmax, env=e, hw=hw)
            t_p = render_march.march_csg_plain(lib, state, params, o_w, d_w, tmax, env=e)
            torch.cuda.synchronize()
            assert render_march.march_csg.launches == n0 + 1
            _frames_agree(lib, state, params, cam, H, W, e, d_w, d_cam, tmax, t_k, t_p)
    # inactive bodies are culled: the kernel never hits them
    state.active[1] = False
    t_k = render_march.march_csg(lib, state, params, o_w, d_w, tmax, env=env, hw=(H, W))
    seg = raymarch.shade(lib, state, params, cam, H, W, env, d_w, d_cam, tmax, t_k)["seg"]
    assert not (seg == 1).any()


def _render_batch_inputs(dev, batch=4):
    specs = (("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3))
    cfg, lib, env, states, params = _pile_batch(dev, specs, 32, 10, batch, 60)
    H, W = 96, 128
    K, cam = _top_camera(dev, H, W, 140.0, z=0.7)
    return lib, env, states, params, K, cam, H, W


def test_march_batch_kernel_matches_each_scene_and_the_plain_march(dev):
    """One launch over a batch gives each scene's t bit for bit as the scene
    marched alone, and agrees with the plain march."""
    lib, env, states, params, K, cam, H, W = _render_batch_inputs(dev)
    o_w, d_w, d_cam, tmax = raymarch.camera_rays(K, cam, H, W)
    kw = dict(env=env, hw=(H, W))
    n0 = render_march.march_csg.launches
    t_b = render_march.march_csg_batch(lib, states, params, o_w, d_w, tmax, **kw)
    assert render_march.march_csg.launches == n0 + 1 and t_b.shape == (4, H * W)
    t_p = render_march.march_csg_plain(lib, states, params, o_w, d_w, tmax, env=env)
    seen = set()
    for b in range(4):
        st, pr = index_scenes(states, b), index_scenes(params, b)
        assert torch.equal(t_b[b], render_march.march_csg(lib, st, pr, o_w, d_w, tmax, **kw))
        seen |= set(_frames_agree(lib, st, pr, cam, H, W, env, d_w, d_cam, tmax, t_b[b],
                                  t_p[b]).unique().tolist())
    assert len(seen - {-1, -2}) >= 4  # the frames show bodies
    # the render batch is one launch
    n0 = render_march.march_csg.launches
    out = raymarch.render_batch(lib, states, params, K, cam, H, W, env=env)
    assert render_march.march_csg.launches == n0 + 1 and out["seg"].shape == (4, H, W)


def _assert_cull_lists_match(lib, states, params, o_w, d_w, hw, tile=None):
    vk, nk = render_march.tile_visibility_kernel(lib, states, params, o_w, d_w, hw=hw, tile=tile)
    radius_w = lib.radius[params.shape_id] * params.scale
    vp, np_ = render_march.tile_visibility(o_w, d_w, states.pos, radius_w, states.active, hw,
                                           tile)
    margin, _ = render_march.cull_margin(o_w, d_w, states.pos, radius_w, hw, tile)
    N = vk.shape[-1]
    body = torch.arange(N, device=vk.device)
    in_k = (vk.long()[..., None] == body).any(dim=-2)
    in_p = (torch.where(body < np_[..., None], vp, -1).long()[..., None] == body).any(dim=-2)
    differ = in_k != in_p
    # a body may fall on the other side only within 1e-5 of the threshold
    assert bool((~differ | ((margin + 1e-4).abs() < 1e-5)).all())
    assert differ.sum().item() <= 1e-3 * differ.numel()
    # the kernel lists the visible bodies in index order, then -1
    assert torch.equal(vk >= 0, body < nk[..., None])
    assert bool(((vk[..., 1:] > vk[..., :-1]) | (vk[..., 1:] < 0)).all())
    return nk


@pytest.mark.parametrize("hw,tile", [
    (None, None),  # a bare ray set: 256-ray strips, a ragged last strip
    ((96, 128), None),  # 8x8 tiles
    ((100, 130), None),  # ragged 8x8 tiles on both edges
    ((96, 128), (8, 32)), ((96, 128), (32, 8)), ((100, 130), (16, 16)), ((100, 130), (5, 7)),
])
def test_march_kernel_cull_lists_match_the_plain_cull(dev, hw, tile):
    lib, env, states, params, K, cam, H, W = _render_batch_inputs(dev)
    h, w = hw if hw is not None else (H, W)
    K, cam = _top_camera(dev, h, w, 140.0, z=0.7)
    o_w, d_w, _, tmax = raymarch.camera_rays(K, cam, h, w)
    n0 = render_march.march_csg.launches
    nk = _assert_cull_lists_match(lib, states, params, o_w, d_w, hw, tile)
    assert render_march.march_csg.launches == n0  # the cull's own launch is not counted
    assert nk.min().item() < nk.max().item()  # the cull keeps some bodies and drops others
    if tile is not None or hw is not None:  # the march takes these tiles too
        t_k = render_march._march(lib, states, params, o_w, d_w, tmax, env=env, hw=hw, tile=tile)
        t_p = render_march.march_csg_plain(lib, states, params, o_w, d_w, tmax, env=env)
        hit_k, hit_p = t_k < tmax * 0.999, t_p < tmax * 0.999
        assert (hit_k != hit_p).float().mean().item() < 0.005


def test_march_kernel_at_its_limits(dev):
    """0 active bodies, no env, 32 bodies and 16 env boxes (some disabled),
    against the plain march; 33 bodies or 17 env boxes raise."""
    lib, state, params, env = _march_scene(dev)
    H, W = 60, 90
    K, cam = _top_camera(dev, H, W, 120.0)
    o_w, d_w, d_cam, tmax = raymarch.camera_rays(K, cam, H, W)
    # no active body: the env alone; no env: the bodies alone; neither
    for st, e in ((state.replace(active=torch.zeros_like(state.active)), env), (state, None),
                  (state.replace(active=torch.zeros_like(state.active)), None)):
        t_k = render_march.march_csg(lib, st, params, o_w, d_w, tmax, env=e, hw=(H, W))
        t_p = render_march.march_csg_plain(lib, st, params, o_w, d_w, tmax, env=e)
        _frames_agree(lib, st, params, cam, H, W, e, d_w, d_cam, tmax, t_k, t_p)
    assert torch.equal(t_k, tmax)  # nothing to hit: every ray runs to tmax
    # 32 bodies on a grid, every shape, and 16 env boxes, a third disabled
    n = 32
    gx, gy = torch.meshgrid(torch.arange(8), torch.arange(4), indexing="ij")
    big = SceneState.create(n, device=dev)
    big.pos[:] = torch.stack([(gx.flatten() - 3.5) * 0.025, (gy.flatten() - 1.5) * 0.03,
                              torch.full((n,), 0.02)], dim=1).to(dev)
    big.quat[:, 0] = 1.0
    big.active[:] = True
    big.active[5] = False
    bpar = SceneParams.create(lib, [i % 3 for i in range(n)], [0.8 + 0.01 * i for i in range(n)])
    centers = [(0.11 * (i % 4 - 1.5), 0.11 * (i // 4 - 1.5), -0.01 - 0.001 * i) for i in range(16)]
    env16 = engine.StaticEnv.boxes(centers, [(0.05, 0.05, 0.005)] * 16, device=dev)
    env16 = env16.replace(enabled=torch.arange(16, device=dev) % 3 != 0)
    t_k = render_march.march_csg(lib, big, bpar, o_w, d_w, tmax, env=env16, hw=(H, W))
    t_p = render_march.march_csg_plain(lib, big, bpar, o_w, d_w, tmax, env=env16)
    seg = _frames_agree(lib, big, bpar, cam, H, W, env16, d_w, d_cam, tmax, t_k, t_p)
    assert len(set(seg.unique().tolist()) - {-1, -2}) >= 20 and (seg == -2).any()
    assert not (seg == 5).any()
    _assert_cull_lists_match(lib, as_batch(big), as_batch(bpar), o_w, d_w, (H, W))
    # beyond the limits, and what the kernel does not take, raise before any launch
    n0 = render_march.march_csg.launches
    more = SceneState.create(33, device=dev)
    with pytest.raises(ValueError, match="33 bodies"):
        render_march.march_csg(lib, more, SceneParams.create(lib, [0] * 33), o_w, d_w, tmax)
    env17 = engine.StaticEnv.boxes(centers + [(0.0, 0.0, -0.05)], [(0.05, 0.05, 0.005)] * 17,
                                   device=dev)
    with pytest.raises(ValueError, match="17 env boxes"):
        render_march.march_csg(lib, big, bpar, o_w, d_w, tmax, env=env17)
    with pytest.raises(ValueError, match="float32"):
        render_march.march_csg(lib, state.replace(pos=state.pos.double()), params, o_w, d_w, tmax)
    with pytest.raises(ValueError, match="contiguous"):
        render_march.march_csg(lib, state.replace(quat=state.quat.t().contiguous().t()), params,
                               o_w, d_w, tmax)
    with pytest.raises(ValueError, match="image has"):
        render_march.march_csg(lib, state, params, o_w, d_w, tmax, hw=(H, W + 1))
    with pytest.raises(ValueError, match="rays a tile"):
        render_march._march(lib, state, params, o_w, d_w, tmax, hw=(H, W), tile=(16, 32))
    assert render_march.march_csg.launches == n0


def _pile_batch(dev, specs, n_surf, max_bodies, batch, fall_steps):
    """A reset batch over the open bin, dropped for ``fall_steps`` through
    the kernel so that what follows are contact steps."""
    lib = build_shape_lib([primitives.make_instance(c, "train", i) for c, i in specs],
                          [csg.make_csg_instance(c, "train", i) for c, i in specs],
                          n_surf=n_surf, device=dev)
    cfg = env_pile.PileConfig(max_bodies=max_bodies)
    env = engine.StaticEnv.open_bin(cfg.bin_inner, device=dev)
    states, params = env_pile.reset_batch(torch.Generator(device=dev).manual_seed(0), lib, cfg,
                                          batch)
    states = fused_rollout.rollout_fused(states, params, lib, env, fall_steps, dt=cfg.dt)
    return cfg, lib, env, states, params


FIELDS = ("pos", "quat", "linvel", "angvel")


@pytest.mark.parametrize("specs,n_surf,max_bodies,batch", [
    ((("nut", 0), ("screw", 0)), 16, 4, 37),  # two bodies a warp, a ragged batch
    ((("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3)), 32, 10, 64),  # the bench's shapes
    ((("hnm", 0), ("screw", 0)), 20, 3, 5),  # points not a power of two, a padded last warp
])
def test_rollout_kernel_matches_plain(dev, specs, n_surf, max_bodies, batch):
    cfg, lib, env, states, params = _pile_batch(dev, specs, n_surf, max_bodies, batch, 60)
    for n_steps in (1, 5):
        n0 = fused_rollout.rollout_fused.launches
        k = fused_rollout.rollout_fused(states, params, lib, env, n_steps, dt=cfg.dt)
        p = fused_rollout.rollout_fused_plain(states, params, lib, env, n_steps, dt=cfg.dt)
        torch.cuda.synchronize()
        assert fused_rollout.rollout_fused.launches == n0 + 1
        act = k.active
        err = {f: (getattr(k, f) - getattr(p, f)).abs().amax(dim=-1)[act] for f in FIELDS}
        within = ((err["pos"] < 1e-4) & (err["quat"] < 1e-3) & (err["linvel"] < 1e-2)
                  & (err["angvel"] < 1e-2))
        # a contact that flips at phi ~ 0 may put single bodies outside
        assert within.float().mean().item() >= 0.99, {f: e.max().item() for f, e in err.items()}
        assert torch.equal(k.pos[~act], states.pos[~act])
    # the compared steps were contact steps
    assert (k.linvel[..., 2].abs() < 0.9 * 9.8 * 60 * cfg.dt)[k.active].any()
    # deterministic: the same input gives the same bits
    a = fused_rollout.rollout_fused(states, params, lib, env, 30, dt=cfg.dt)
    b = fused_rollout.rollout_fused(states, params, lib, env, 30, dt=cfg.dt)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
    # a scene alone gives what it gives in the batch
    one = fused_rollout.rollout_fused(index_scenes(states, slice(2, 3)),
                                      index_scenes(params, slice(2, 3)), lib, env, 30, dt=cfg.dt)
    assert torch.equal(one.pos[0], a.pos[2])


def _within(k, p):
    act = k.active
    err = {f: (getattr(k, f) - getattr(p, f)).abs().amax(dim=-1)[act] for f in FIELDS}
    return ((err["pos"] < 1e-4) & (err["quat"] < 1e-3) & (err["linvel"] < 1e-2)
            & (err["angvel"] < 1e-2)).float().mean().item()


def test_rollout_kernel_on_no_contact_settled_and_all_active_batches(dev):
    """The regimes the kernel treats apart: a call with no contact at all
    (the solver is skipped), settled piles (dense contacts, more than the two
    a thread keeps) and scenes with every body active (no warp leaves)."""
    specs = (("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3))
    cfg, lib, env, fresh, params = _pile_batch(dev, specs, 32, 10, 64, 0)
    args = (params, lib, env)
    # no contact: the first steps after the reset are free fall
    k = fused_rollout.rollout_fused(fresh, *args, 5, dt=cfg.dt)
    p = fused_rollout.rollout_fused_plain(fresh, *args, 5, dt=cfg.dt)
    free = 9.8 * 5 * cfg.dt
    assert (k.linvel[..., 2].abs() > 0.9 * free)[k.active].all()
    assert _within(k, p) == 1.0
    assert torch.equal(k.pos[~k.active], fresh.pos[~k.active])
    # settled: 250 steps on, nearly every body at rest
    settled = fused_rollout.rollout_fused(fresh, *args, 250, dt=cfg.dt)
    assert (settled.linvel[..., 2].abs() < 0.1)[settled.active].float().mean().item() > 0.9
    for n_steps in (1, 5):
        k = fused_rollout.rollout_fused(settled, *args, n_steps, dt=cfg.dt)
        p = fused_rollout.rollout_fused_plain(settled, *args, n_steps, dt=cfg.dt)
        assert _within(k, p) >= 0.99
    # every body active
    gen = torch.Generator(device=dev).manual_seed(1)
    full, fpar = env_pile.reset_batch(gen, lib, cfg, 32, n_objects=10)
    assert full.active.all()
    full = fused_rollout.rollout_fused(full, fpar, lib, env, 60, dt=cfg.dt)
    k = fused_rollout.rollout_fused(full, fpar, lib, env, 5, dt=cfg.dt)
    p = fused_rollout.rollout_fused_plain(full, fpar, lib, env, 5, dt=cfg.dt)
    torch.cuda.synchronize()
    assert _within(k, p) >= 0.99
    # no steps: the state comes back as it went in
    same = fused_rollout.rollout_fused(settled, *args, 0, dt=cfg.dt)
    assert all(torch.equal(getattr(same, f), getattr(settled, f)) for f in FIELDS)


def test_rollout_kernel_settles_and_keeps_static_bodies(dev):
    specs = (("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3))
    cfg, lib, env, states, params = _pile_batch(dev, specs, 32, 10, 128, 0)
    k = fused_rollout.rollout_fused(states, params, lib, env, 150, dt=cfg.dt)
    p = fused_rollout.rollout_fused_plain(states, params, lib, env, 150, dt=cfg.dt)
    torch.cuda.synchronize()
    act = k.active
    zk, zp = k.pos[..., 2][act], p.pos[..., 2][act]
    # the algorithm lets a body that reaches the 1 cm floor at ~2 m/s (the top
    # of a 10-body column) pass through it: rare, and the same bodies in both
    low_k, low_p = zk < -0.02, zp < -0.02
    assert torch.equal(low_k, low_p), (low_k.sum().item(), low_p.sum().item())
    assert low_k.sum().item() <= 0.02 * zk.numel()
    assert abs(zk[~low_k].mean().item() - zp[~low_p].mean().item()) < 1e-3
    assert zk.median().item() > 0.0 and zk.median().item() < 0.03
    # halving dt keeps the settle height of the bodies that stayed in the bin
    zh = fused_rollout.rollout_fused(states, params, lib, env, 300, dt=cfg.dt / 2).pos[..., 2][act]
    assert abs(zh[zh > -0.02].mean().item() - zk[zk > -0.02].mean().item()) < 0.01
    # a static body (held in mid-air, the others fall past it) stays where it is
    mass, inertia = params.mass.clone(), params.inertia.clone()
    mass[:, 0], inertia[:, 0] = 1e9, 1e9
    s = fused_rollout.rollout_fused(states, params.replace(mass=mass, inertia=inertia), lib, env,
                                    30, dt=cfg.dt)
    assert torch.equal(s.pos[:, 0], states.pos[:, 0]) and torch.equal(s.quat[:, 0],
                                                                      states.quat[:, 0])
    assert (s.pos[:, 1:] - states.pos[:, 1:]).abs().max().item() > 1e-3  # the rest fell


def test_rollout_rejects_what_the_kernel_cannot_take(dev):
    specs = (("nut", 0),)
    lib = build_shape_lib([primitives.make_instance(c, "test", i) for c, i in specs],
                          [csg.make_csg_instance(c, "test", i) for c, i in specs],
                          n_surf=256, device=dev)
    cfg = env_pile.PileConfig(max_bodies=6)
    env = engine.StaticEnv.open_bin(cfg.bin_inner, device=dev)
    states, params = env_pile.reset_batch(torch.Generator(device=dev).manual_seed(0), lib, cfg, 2)
    n0 = fused_rollout.rollout_fused.launches
    # the eval's own shapes: 6 bodies x 256 points do not fit a block
    with pytest.raises(ValueError, match="N=6 bodies, P=256 points"):
        fused_rollout.rollout_fused(states, params, lib, env, 1)
    with pytest.raises(ValueError, match="float32"):
        fused_rollout.rollout_fused(states.replace(pos=states.pos.double()), params, lib, env, 1)
    assert fused_rollout.rollout_fused.launches == n0
