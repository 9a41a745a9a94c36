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
from catgrasp_tpu_torch.ops import collision, render_march
from catgrasp_tpu_torch.render import raymarch
from catgrasp_tpu_torch.sim import engine
from catgrasp_tpu_torch.sim.env_grasp import GripperSpec
from catgrasp_tpu_torch.sim.types import SceneParams, SceneState, build_shape_lib

torch.set_num_threads(2)
OFFSETS = tuple(float(o) for o in gfilter.ADJUST_OFFSETS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_box_hits_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    n, c = 3001, 2500  # ragged against the 256-pose blocks and 1,024-point tiles
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
    with pytest.raises(RuntimeError):
        collision.box_hits(t_inv, cloud, mask, boxes, tuple([0.0] * 9), 5e-4)


def test_march_kernel_matches_plain(dev):
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
    H, W = 100, 300  # 30,000 rays: a ragged last tile
    K = torch.tensor([[250.0, 0, W / 2], [0, 250.0, H / 2], [0, 0, 1.0]], device=dev)
    cam = torch.eye(4, device=dev)
    cam[:3, :3] = torch.tensor([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    cam[2, 3] = 0.3
    o_w, d_w, d_cam, tmax = raymarch.camera_rays(K, cam, H, W)
    for e in (env, None):
        n0 = render_march.march_csg.launches
        t_k = render_march.march_csg(lib, state, params, o_w, d_w, tmax, env=e)
        t_p = render_march.march_csg_plain(lib, state, params, o_w, d_w, tmax, env=e)
        out_k = raymarch.shade(lib, state, params, cam, H, W, e, d_w, d_cam, tmax, t_k)
        out_p = raymarch.shade(lib, state, params, cam, H, W, e, d_w, d_cam, tmax, t_p)
        torch.cuda.synchronize()
        assert render_march.march_csg.launches == n0 + 1
        agree = (out_k["seg"] == out_p["seg"]).float().mean().item()
        assert agree > 0.995
        both = (out_k["seg"] == out_p["seg"]) & (out_p["seg"] != -1)
        assert (out_k["depth"] - out_p["depth"])[both].abs().max().item() < 2e-3
        assert set(out_k["seg"].unique().tolist()) == set(out_p["seg"].unique().tolist())
    # inactive bodies are culled: the kernel never hits them
    state.active[1] = False
    t_k = render_march.march_csg(lib, state, params, o_w, d_w, tmax, env=env)
    seg = raymarch.shade(lib, state, params, cam, H, W, env, d_w, d_cam, tmax, t_k)["seg"]
    assert not (seg == 1).any()
