"""Training-data generation: the port's ``render/raymarch.py`` visibility and
per-scene cameras and ``pipelines/generate_pile_data.py`` against the JAX
package on the same inputs.  JAX's draws (``jax.random``) cannot be made in
torch, so the piles and the camera candidates are drawn on the JAX side and
carried over as arrays."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.data import labels as jlabels
from catgrasp_tpu.pipelines import generate_pile_data as jgpd
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.data import labels
from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
from catgrasp_tpu_torch.render import raymarch
from catgrasp_tpu_torch.sim.types import index_scenes, stack_scenes
from test_torch_common import port_env, port_lib, port_params, port_state, t2n

torch.set_num_threads(2)
B, N = 2, 4  # scenes, bodies a pile


@pytest.fixture(scope="module")
def piles():
    """Two settled JAX piles of up to 4 nut bodies and the JAX cameras."""
    lib = jgpd.category_lib("nut", "train", n_surf=16)
    cfg = jpile.PileConfig(max_bodies=N, scale_range=(0.5, 2.0))
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    keys = jax.random.split(jax.random.PRNGKey(3), B + 1)
    states, params = jax.vmap(lambda k: jpile.reset(k, lib, cfg, n_objects=N))(keys[:B])
    states = jax.vmap(lambda s, p: jpile.settle_fixed(s, p, lib, env, cfg, 60))(states, params)
    cams = jax.vmap(jgpd.random_camera)(jax.random.split(keys[B], B))
    return lib, states, params, env, np.asarray(cams)


def _scene(tree, b):
    return jax.tree.map(lambda x: x[b], tree)


def _small_k(scale: float):
    K = np.array(load_config("config.yml")["K"], np.float32).reshape(3, 3)
    K[:2] *= scale
    return K


def test_visibility_matches_jax(piles, monkeypatch):
    """``visibility_ratio_batch`` (full and solo frames in one
    ``march_csg_batch`` call, the plain march on the CPU) against JAX's
    ``visibility_ratio`` (its XLA march) scene by scene: per-body ratios
    within 1e-3 on a 48x64 frame."""
    lib, states, params, env, cams = piles
    K, H, W = _small_k(0.031), 48, 64
    plib = port_lib(lib)
    pst = stack_scenes([port_state(_scene(states, b)) for b in range(B)])
    ppar = stack_scenes([port_params(_scene(params, b)) for b in range(B)])
    from catgrasp_tpu_torch.ops import render_march as rm
    calls = []
    entry = rm.march_csg_batch
    monkeypatch.setattr(rm, "march_csg_batch",
                        lambda *a, **k: calls.append(tuple(a[1].pos.shape[:2])) or entry(*a, **k))
    vis = t2n(raymarch.visibility_ratio_batch(plib, pst, ppar, K, torch.as_tensor(cams), H, W))
    assert calls == [(B * (N + 1), N)]  # one batch: B full frames + B x N solo frames
    for b in range(B):
        vj = np.asarray(jraymarch.visibility_ratio(lib, _scene(states, b), _scene(params, b),
                                                   jnp.asarray(K), jnp.asarray(cams[b]), H, W))
        np.testing.assert_allclose(vis[b], vj, atol=1e-3)
    assert (vis > 0).sum() >= 3 and (vis[vis > 0] < 1).any()  # visible and occluded bodies
    # the one-scene form
    v0 = raymarch.visibility_ratio(plib, index_scenes(pst, 0), index_scenes(ppar, 0), K,
                                   torch.as_tensor(cams[0]), H, W)
    np.testing.assert_array_equal(t2n(v0), vis[0])


def _jax_draws(key):
    """The 8 candidate draws of JAX's ``random_camera(key)``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    dxy = jax.random.uniform(k1, (8, 2), minval=-0.05, maxval=0.05)
    dz = jax.random.uniform(k2, (8,), minval=-0.05, maxval=0.05)
    axis = jtf.random_direction(k3, (8,))
    ang = jax.random.uniform(k4, (8,), minval=-1.0, maxval=1.0) * jnp.deg2rad(10.0)
    return [torch.as_tensor(np.asarray(a))[None] for a in (dxy, dz, axis, ang)]


@pytest.mark.parametrize("scale,hw", [(0.25, (386, 516)), (0.23, (330, 450)),
                                      (0.5, (386, 516))],
                         ids=["config", "tight", "none_fits"])
def test_camera_pick_matches_jax(scale, hw, monkeypatch):
    """``pick_camera`` fed JAX's candidate draws picks JAX's camera: in the
    config's frame and a tighter one (a jittered candidate, or straight
    down where none of the 8 fits), and in one no candidate fits (straight
    down every time)."""
    K = _small_k(scale)
    monkeypatch.setattr(jgpd, "_CAM_K_FOR_JITTER", K)
    monkeypatch.setattr(jgpd, "_CAM_HW_FOR_JITTER", hw)
    picks = []
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        cj = np.asarray(jgpd.random_camera(key))
        cp = t2n(gpd.pick_camera(*_jax_draws(key), K, hw))[0]
        np.testing.assert_allclose(cp, cj, atol=2e-6)
        picks.append(np.allclose(cj[:3, :3], np.diag([1.0, -1.0, -1.0]), atol=1e-7))
    assert all(picks) if scale == 0.5 else not all(picks)


def test_camera_draws_have_the_reference_magnitudes():
    g = torch.Generator().manual_seed(0)
    dxy, dz, axis, ang = gpd.camera_candidates(g, 64)
    assert dxy.shape == (64, 8, 2) and float(dxy.abs().max()) <= 0.05
    assert float(dz.abs().max()) <= 0.05 and float(ang.abs().max()) <= np.deg2rad(10.0)
    np.testing.assert_allclose(t2n(torch.linalg.vector_norm(axis, dim=-1)), 1.0, atol=1e-6)
    cams = gpd.random_camera(torch.Generator().manual_seed(0), 16, _small_k(0.25), (386, 516))
    assert cams.shape == (16, 4, 4) and float((cams[:, 2, 3] - 0.6).abs().max()) <= 0.05


def test_scene_record_matches_jax(piles):
    """One batch's encoded record from the same settled piles and cameras,
    as the data generator makes it (``march_frames``: one march of both
    scenes in their cameras' frames, the bin's boxes as bodies; then
    ``shade_frames``), against JAX's per-scene ``render``: seg equal on >
    99.5% of pixels and on >= 99% of the pixels where either sees a body,
    the same bodies seen, depth u16 within 2 counts where both hit, rgb,
    NUNOCS and normals alike."""
    lib, states, params, env, cams = piles
    K, H, W = _small_k(0.05), 77, 103
    plib, penv = port_lib(lib), port_env(env)
    pst = stack_scenes([port_state(_scene(states, b)) for b in range(B)])
    ppar = stack_scenes([port_params(_scene(params, b)) for b in range(B)])
    ct = torch.as_tensor(cams)
    Kt = torch.as_tensor(K, dtype=torch.float32)
    t, d_cam, tmax = raymarch.march_frames(plib, pst, ppar, Kt, ct, H, W, env=penv)
    outs = raymarch.shade_frames(plib, pst, ppar, ct, H, W, penv, d_cam, tmax, t)
    vis = torch.ones((B, N))
    enc = {k: t2n(v) for k, v in gpd.encode_batch(outs, pst, ppar, ct, vis).items()}
    for b in range(B):
        oj = jraymarch.render(lib, _scene(states, b), _scene(params, b), jnp.asarray(K),
                              jnp.asarray(cams[b]), H, W, env=env)
        seg_j = np.asarray(oj["seg"]).astype(np.int16)
        assert (enc["seg"][b] == seg_j).mean() > 0.995
        assert {-2, -1} <= set(np.unique(seg_j).tolist()) and (seg_j >= 0).sum() > 20
        assert set(np.unique(enc["seg"][b]).tolist()) == set(np.unique(seg_j).tolist())
        bodies = (enc["seg"][b] >= 0) | (seg_j >= 0)
        assert (enc["seg"][b] == seg_j)[bodies].mean() >= 0.99
        dj = np.round(np.asarray(oj["depth"]) * 1e4).astype(np.uint16).astype(np.int64)
        both = (enc["seg"][b] == seg_j) & (seg_j != -1)
        assert np.abs(enc["depth"][b].astype(np.int64) - dj)[both].max() <= 2
        same = enc["seg"][b] == seg_j
        rgb_j = (np.asarray(oj["rgb"]) * 255).astype(np.uint8)
        assert np.abs(enc["rgb"][b].astype(int) - rgb_j)[same].max() <= 2
        for k in ("nocs", "normal"):
            d = np.abs(enc[k][b].astype(np.float32) - np.asarray(oj[k]).astype(np.float16))
            assert d[same & (seg_j >= 0)].max() <= 2e-3, k
        pose_j = np.asarray(jax.vmap(jtf.pose_from_qt)(states.quat[b], states.pos[b]))
        np.testing.assert_allclose(enc["ob_in_world"][b], pose_j, atol=1e-6)
    assert enc["depth"].dtype == np.int32 and enc["seg"].dtype == np.int16
    assert enc["nocs"].dtype == np.float16 and enc["rgb"].dtype == np.uint8
    assert enc["shape_id"].dtype == np.int32


def _tiny_cfg():
    cfg = load_config("config.yml")
    cfg["render_downscale"] = 0.02  # 30x41 frames, 7x10 visibility
    return cfg


def test_generated_files_read_in_both_packages(tmp_path):
    """``generate_scenes`` on the CPU at a tiny size: JAX's schema (keys and
    dtypes), read the same by JAX's ``labels.load_scene`` and the port's;
    a resumed run (``--start``) continues the draws of an uninterrupted
    one."""
    cfg = _tiny_cfg()
    kw = dict(cfg=cfg, settle_steps=4, batch=2, device="cpu")
    gpd.generate_scenes("nut", "train", 4, str(tmp_path / "a"), **kw)
    gpd.generate_scenes("nut", "train", 4, str(tmp_path / "b"), start=2, **kw)
    files = sorted(glob.glob(str(tmp_path / "a" / "*.npz")))
    assert [os.path.basename(f) for f in files] == [f"{i:07d}.npz" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "b")) == ["0000002.npz", "0000003.npz"]
    dtypes = {"rgb": "uint8", "depth": "uint16", "seg": "int16", "nocs": "float16",
              "normal": "float16", "ob_in_world": "float32", "scales": "float32",
              "shape_id": "int32", "active": "bool", "vis_ratio": "float32", "K": "float32",
              "cam_in_world": "float32", "class_name": "<U3"}
    for f in files:
        with np.load(f) as z:
            assert {k: str(z[k].dtype) for k in z.files} == dtypes
        sj, sp = jlabels.load_scene(f), labels.load_scene(f)
        assert sorted(sj) == sorted(sp)
        for k in sj:
            np.testing.assert_array_equal(sp[k], sj[k])
        assert sp["depth"].shape == (30, 41) and sp["xyz"].shape == (30, 41, 3)
    for i in (2, 3):
        with np.load(tmp_path / "a" / f"{i:07d}.npz") as za, \
                np.load(tmp_path / "b" / f"{i:07d}.npz") as zb:
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])


def test_scene_range_errors_as_jax(tmp_path):
    with pytest.raises(ValueError, match="multiple of batch=16"):
        gpd.generate_scenes("nut", "train", 64, str(tmp_path), start=8, device="cpu")
    with pytest.raises(ValueError, match="exclusive END scene id"):
        gpd.generate_scenes("nut", "train", 32, str(tmp_path), start=32, device="cpu")
    assert gpd.default_out_dir("nut", "val") == "dataset/torch/nut/val"
    assert gpd.frame_geometry(load_config("config.yml"))[1:] == (386, 516)
    lib = gpd.category_lib("nut", "test", n_surf=8, device="cpu")
    from catgrasp_tpu.geom import primitives as jprim
    assert lib.num_shapes == jprim.num_instances("nut", "test")
