"""Port parity: the pinhole camera (``core/camera.py``) and the row-strip
render ``render_chunked`` against the JAX package.

The camera's functions are held to JAX's outputs within 1e-5 and to JAX's
round trip (``tests/test_transforms.py``).  ``render_chunked`` on the CPU
marches with K2's plain version, as ``render`` does, so its frame equals
the port's own ``render`` bit for bit on every channel (as
``tests/test_render_chunked.py`` holds JAX), with an uneven last strip and
with an exact multiple; against JAX's ``render_chunked`` it is held to the
render tolerances of ``tests/test_torch_render.py``: seg on > 99.5% of
pixels, depth within 2e-3 m where seg agrees."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import camera as jcamera
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.core import camera as pcamera
from catgrasp_tpu_torch.render import raymarch as praymarch
from test_torch_common import (pile_scene_jax, port_env, port_lib, port_params, port_state,
                               t2n, top_camera)

torch.set_num_threads(2)


def test_camera_from_config_and_scaled_match_jax():
    """The reference camera from the port's ``config.yml``, full size and
    at the data generator's 0.25 (``round`` on the image size)."""
    cfg = load_config("config.yml")
    jc, pc = jcamera.Camera.from_config(cfg), pcamera.Camera.from_config(cfg)
    assert (pc.H, pc.W, pc.zfar, pc.znear) == (jc.H, jc.W, jc.zfar, jc.znear) == \
        (1544, 2064, 3.0, 0.1)
    np.testing.assert_array_equal(pc.K, jc.K)
    assert pc.K.dtype == np.float32 and isinstance(pc.K, np.ndarray)
    for f in (0.25, 0.3, 1 / 3):
        js, ps = jc.scaled(f), pc.scaled(f)
        assert (ps.H, ps.W) == (js.H, js.W)
        np.testing.assert_array_equal(ps.K, js.K)
    assert (pc.scaled(0.25).H, pc.scaled(0.25).W) == (386, 516)


def test_depth_to_xyzmap_roundtrip_and_jax(rng):
    """JAX's round trip (depth -> xyz -> pixels), and the three functions
    within 1e-5 of JAX's on the same inputs, invalid pixels zeroed."""
    K = np.array([[200.0, 0, 32], [0, 200.0, 24], [0, 0, 1]], np.float32)
    depth = rng.uniform(0.5, 2.0, size=(48, 64)).astype(np.float32)
    depth[::7, ::5] = 0.05  # below min_depth
    xyz = pcamera.depth_to_xyzmap(torch.from_numpy(depth), torch.from_numpy(K))
    valid = depth >= 0.1
    np.testing.assert_allclose(t2n(xyz[..., 2])[valid], depth[valid], atol=1e-5)
    assert (t2n(xyz)[~valid] == 0).all()
    np.testing.assert_allclose(t2n(xyz), np.asarray(jcamera.depth_to_xyzmap(
        jnp.asarray(depth), jnp.asarray(K))), atol=1e-5)
    uv = pcamera.project_points(xyz.reshape(-1, 3), torch.from_numpy(K)).reshape(48, 64, 2)
    us, vs = np.meshgrid(np.arange(64), np.arange(48))
    np.testing.assert_allclose(t2n(uv[..., 0])[valid], us[valid], atol=1e-2)
    np.testing.assert_allclose(t2n(uv[..., 1])[valid], vs[valid], atol=1e-2)
    np.testing.assert_allclose(t2n(uv), np.asarray(jcamera.project_points(
        jnp.asarray(t2n(xyz)).reshape(-1, 3), jnp.asarray(K))).reshape(48, 64, 2), atol=1e-5)


def test_pixel_rays_match_jax():
    """JAX's ``pixel_rays`` stacks a (1, W) and an (H, 1) grid, so it runs
    only on a 1 x 1 image (no JAX code calls it); there the port equals it
    within 1e-5 at several principal points.  On a whole image the port
    broadcasts the two grids, and its rays are the JAX render's own camera
    rays (``render/raymarch.py:_render_impl``), in numpy."""
    for cx, cy in ((0.0, 0.0), (-3.5, 2.0), (40.0, -17.25)):
        K = np.array([[210.0, 0, cx], [0, 190.0, cy], [0, 0, 1]], np.float32)
        np.testing.assert_allclose(t2n(pcamera.pixel_rays(torch.from_numpy(K), 1, 1)),
                                   np.asarray(jcamera.pixel_rays(jnp.asarray(K), 1, 1)),
                                   atol=1e-5)
    cam = pcamera.Camera.from_config(load_config("config.yml")).scaled(0.05)
    with pytest.raises(ValueError):
        jcamera.pixel_rays(jnp.asarray(cam.K), cam.H, cam.W)
    rays = pcamera.pixel_rays(torch.from_numpy(cam.K), cam.H, cam.W)
    assert rays.shape == (cam.H, cam.W, 3)
    us, vs = np.meshgrid(np.arange(cam.W, dtype=np.float32), np.arange(cam.H, dtype=np.float32))
    d = np.stack([(us - cam.K[0, 2]) / cam.K[0, 0], (vs - cam.K[1, 2]) / cam.K[1, 1],
                  np.ones_like(us)], axis=-1)
    np.testing.assert_allclose(t2n(rays), d / np.linalg.norm(d, axis=-1, keepdims=True),
                               atol=1e-6)


@pytest.fixture(scope="module")
def scene():
    lib, state, params, env = pile_scene_jax()
    return (lib, state, params, env), (port_lib(lib), port_state(state),
                                       port_params(params), port_env(env))


# 70 = 2 x 32 + 6: the padded and cropped last strip; 64 = 4 x 16: an exact multiple
CASES = [((70, 64), 32, 260.0), ((64, 48), 16, 240.0)]


@pytest.mark.parametrize("hw,rows,f", CASES, ids=["uneven", "exact"])
def test_render_chunked_equals_render_bit_for_bit(scene, hw, rows, f):
    _, (lib, state, params, env) = scene
    H, W = hw
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cam = torch.from_numpy(top_camera())
    full = praymarch.render(lib, state, params, K, cam, H, W, env=env)
    chk = praymarch.render_chunked(lib, state, params, K, cam, H, W, env=env,
                                   rows_per_chunk=rows)
    assert (t2n(full["seg"]) >= 0).sum() > 100  # the pile is in view
    assert set(chk) == set(full)
    for k in full:
        assert chk[k].shape == full[k].shape and chk[k].dtype == full[k].dtype, k
        np.testing.assert_array_equal(t2n(chk[k]), t2n(full[k]), err_msg=k)


@pytest.mark.parametrize("hw,rows,f", CASES, ids=["uneven", "exact"])
def test_render_chunked_matches_jax(scene, hw, rows, f):
    (jlib, jstate, jparams, jenv), (lib, state, params, env) = scene
    H, W = hw
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    ref = jraymarch.render_chunked(jlib, jstate, jparams, jnp.asarray(K),
                                   jnp.asarray(top_camera()), H, W, env=jenv,
                                   rows_per_chunk=rows)
    out = praymarch.render_chunked(lib, state, params, torch.from_numpy(K),
                                   torch.from_numpy(top_camera()), H, W, env=env,
                                   rows_per_chunk=rows)
    seg_r, seg_o = np.asarray(ref["seg"]), t2n(out["seg"])
    assert (seg_r == seg_o).mean() > 0.995
    assert set(np.unique(seg_r)) == set(np.unique(seg_o))
    both = (seg_r == seg_o) & (seg_r != -1)
    np.testing.assert_allclose(t2n(out["depth"])[both], np.asarray(ref["depth"])[both],
                               atol=2e-3)


def test_render_chunked_depth_back_projects_to_its_xyz(scene):
    """``depth_to_xyzmap`` of a chunked frame's depth is the frame's own
    organized cloud (the render's xyz) where something was hit."""
    _, (lib, state, params, env) = scene
    H, W = 70, 64
    K = torch.tensor([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1.0]])
    out = praymarch.render_chunked(lib, state, params, K, torch.from_numpy(top_camera()), H, W,
                                   env=env, rows_per_chunk=32)
    xyz = pcamera.depth_to_xyzmap(out["depth"], K)
    hit = t2n(out["seg"]) != -1
    np.testing.assert_allclose(t2n(xyz)[hit], t2n(out["xyz"])[hit], atol=1e-5)
