"""Port parity: the renderer and kernel K2's plain march against JAX.

On the CPU the port marches with K2's plain version (every body, every
step, no culling), held to the JAX XLA-scan render and to the Pallas
``march_csg`` in interpret mode, one scene or a batch.  The plain versions
of what the kernel does ahead of its march (the per-tile cull over strips or
square pixel tiles, the body and env rows it stages) are held to the cull's
guarantee and to the tables the JAX kernel builds.  Legal divergences are f32 order of
operations, which moves a converged t by ~1e-7 and can flip a pixel on a
silhouette, so seg must agree on > 99.5% of pixels and depth to 2e-3 where
it does (the tolerances of ``tests/test_render_kernel.py``)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.ops import render_march as jrm
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu_torch.ops import render_march as prm
from catgrasp_tpu_torch.render import raymarch as praymarch
from catgrasp_tpu_torch.sim import types as ptypes
from test_torch_common import (pile_scene_jax, port_env, port_lib, port_params, port_state,
                               t2n, top_camera)

torch.set_num_threads(2)
H, W = 32, 64


def _K(f=110.0, h=H, w=W):
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def scene():
    lib, state, params, env = pile_scene_jax()
    return (lib, state, params, env), (port_lib(lib), port_state(state),
                                       port_params(params), port_env(env))


def _assert_render_match(ref, out):
    seg_r, seg_o = np.asarray(ref["seg"]), t2n(out["seg"])
    frac = (seg_r == seg_o).mean()
    assert frac > 0.995, f"seg mismatch on {(1 - frac) * 100:.2f}% of pixels"
    both = (seg_r == seg_o) & (seg_r != -1)
    np.testing.assert_allclose(t2n(out["depth"])[both], np.asarray(ref["depth"])[both],
                               atol=2e-3)
    assert set(np.unique(seg_r)) == set(np.unique(seg_o))
    obj = (seg_r == seg_o) & (seg_r >= 0)
    for k in ("xyz", "normal", "nocs"):
        np.testing.assert_allclose(t2n(out[k])[obj], np.asarray(ref[k])[obj], atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("with_env", [True, False])
def test_render_matches_jax_scan(scene, with_env):
    (lib, state, params, env), (plib, pstate, pparams, penv) = scene
    os.environ["CATGRASP_PALLAS_RENDER"] = "0"
    try:
        ref = jraymarch.render(lib, state, params, jnp.asarray(_K()),
                               jnp.asarray(top_camera()), H, W, env=env, with_env=with_env)
    finally:
        del os.environ["CATGRASP_PALLAS_RENDER"]
    out = praymarch.render(plib, pstate, pparams, torch.from_numpy(_K()),
                           torch.from_numpy(top_camera()), H, W, env=penv,
                           with_env=with_env)
    _assert_render_match(ref, out)
    seg = t2n(out["seg"])
    assert {0, 1, 2} <= set(np.unique(seg))
    if with_env:
        assert (seg == -2).any()


def _rays(K=None, h=H, w=W):
    """The render's rays at (h, w) for the top camera, as numpy."""
    K = _K() if K is None else K
    vs, us = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    d = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                  np.ones_like(us)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam = top_camera()
    d_w = (d @ cam[:3, :3].T).astype(np.float32)
    tmax = (3.0 / np.maximum(d[:, 2], 1e-3)).astype(np.float32)
    return cam[:3, 3].copy(), d_w, tmax


def _assert_march_matches_pallas(t_p, t_j, d_w, tmax):
    hit = (t_j < tmax * 0.999) & (t_p < tmax * 0.999)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(t_p[hit] * -d_w[hit, 2], t_j[hit] * -d_w[hit, 2], atol=2e-3)
    # misses agree too: a ray one side lets escape, the other does not stop
    assert ((t_j < tmax * 0.999) != (t_p < tmax * 0.999)).mean() < 0.005


def test_plain_march_matches_pallas_interpret(scene):
    (lib, state, params, env), (plib, pstate, pparams, penv) = scene
    o, d_w, tmax = _rays()
    t_j = np.asarray(jrm.march_csg(lib, state, params, jnp.asarray(o), jnp.asarray(d_w),
                                   jnp.asarray(tmax), env=env, interpret=True))
    t_p = t2n(prm.march_csg_plain(plib, pstate, pparams, torch.from_numpy(o),
                                  torch.from_numpy(d_w), torch.from_numpy(tmax), env=penv))
    _assert_march_matches_pallas(t_p, t_j, d_w, tmax)


def test_batched_plain_march_equals_a_loop_and_the_pallas_kernel(scene):
    """The plain march over a (B, N, ...) batch gives each scene's t bit for
    bit as the scene alone, and each still matches the Pallas kernel."""
    (lib, state, params, env), (plib, pstate, pparams, penv) = scene
    moved = state.replace(pos=state.pos + jnp.array([0.01, -0.02, 0.0]),
                          active=jnp.array([True, False, True]))
    states = ptypes.stack_scenes([port_state(state), port_state(moved)])
    bparams = ptypes.stack_scenes([pparams, pparams])
    o, d_w, tmax = _rays()
    rays = (torch.from_numpy(o), torch.from_numpy(d_w), torch.from_numpy(tmax))
    t_b = prm.march_csg_plain(plib, states, bparams, *rays, env=penv)
    assert t_b.shape == (2, d_w.shape[0])
    # the batched entry takes the plain march for CPU tensors
    assert torch.equal(prm.march_csg_batch(plib, states, bparams, *rays, env=penv, hw=(H, W)), t_b)
    for b, st in enumerate((state, moved)):
        one = prm.march_csg_plain(plib, port_state(st), pparams, *rays, env=penv)
        assert torch.equal(t_b[b], one)
        t_j = np.asarray(jrm.march_csg(lib, st, params, jnp.asarray(o), jnp.asarray(d_w),
                                       jnp.asarray(tmax), env=env, interpret=True))
        _assert_march_matches_pallas(t2n(t_b[b]), t_j, d_w, tmax)
    assert not torch.equal(t_b[0], t_b[1])


def test_kernel_rows_equal_the_tables_of_the_jax_kernel(scene):
    """The plain body and env rows (what the CUDA kernel stages in shared
    memory) against the rt / scl / par / off / typ / ops / ert tables that
    ``catgrasp_tpu/ops/render_march.py:march_csg`` builds, on the same
    inputs: within f32 rounding (rotations, 1/scale), the gathers exactly;
    one scene or a batch."""
    (lib, state, params, env), (plib, pstate, pparams, penv) = scene
    rng = np.random.default_rng(3)
    q = rng.normal(size=(env.center.shape[0], 4)).astype(np.float32)
    env = env.replace(quat=jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True)))
    penv = port_env(env)
    N, M = state.pos.shape[0], env.center.shape[0]
    R = jtf.quat_to_matrix(state.quat)
    rt = np.asarray(jnp.swapaxes(R, 1, 2).reshape(N, 9))
    scl = np.asarray(jnp.stack([params.scale, 1.0 / params.scale], axis=1))
    sid = params.shape_id
    typ, ops = np.asarray(lib.csg.types[sid]), np.asarray(lib.csg.ops[sid])
    par = np.asarray(lib.csg.params[sid].reshape(N, 12))
    off = np.asarray(lib.csg.offsets[sid].reshape(N, 12))
    ert = np.asarray(jnp.swapaxes(jtf.quat_to_matrix(env.quat), 1, 2).reshape(M, 9))
    f, i = (t2n(x) for x in prm.body_rows(plib, pstate, pparams))
    assert f.shape == (N, 38) and i.shape == (N, 8) and i.dtype == np.int32
    np.testing.assert_array_equal(f[:, :3], np.asarray(state.pos))
    np.testing.assert_allclose(f[:, 3:12], rt, rtol=0, atol=2e-7)
    np.testing.assert_allclose(f[:, 12:14], scl, rtol=2e-7)
    np.testing.assert_array_equal(f[:, 14:26], par)
    np.testing.assert_array_equal(f[:, 26:38], off)
    np.testing.assert_array_equal(i[:, :4], typ)
    np.testing.assert_array_equal(i[:, 4:], ops)
    e = t2n(prm.env_rows(penv))
    assert e.shape == (M, 15)
    np.testing.assert_array_equal(e[:, :3], np.asarray(env.center))
    np.testing.assert_allclose(e[:, 3:12], ert, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(e[:, 12:], np.asarray(env.half))
    # a batch gives each scene's rows
    fb, ib = prm.body_rows(plib, ptypes.stack_scenes([pstate, pstate]),
                           ptypes.stack_scenes([pparams, pparams]))
    assert fb.shape == (2, N, 38) and np.array_equal(t2n(fb[1]), f)
    assert np.array_equal(t2n(ib[0]), i)


@pytest.mark.parametrize("H_,W_,hw,tile,n_tiles", [
    (40, 512, None, None, 80),  # a bare ray set: 256-ray strips
    (40, 512, (40, 512), None, 320),  # the image tile, 8x8
    (45, 500, (45, 500), None, 378),  # 8x8 tiles ragged in both directions
    (40, 512, (40, 512), (16, 16), 96),  # 16x16 tiles, the last row of tiles ragged
    (45, 500, (45, 500), (8, 32), 96),  # ragged in both directions
    (3, 7, None, None, 1),  # fewer rays than a strip
])
def test_tiles_cover_each_ray_once(H_, W_, hw, tile, n_tiles):
    H2, W2, th, tw = prm.tile_geometry(H_ * W_, hw, tile)
    idx, valid = prm.tile_rays(H2, W2, th, tw)
    assert idx.shape == (n_tiles, th * tw)
    assert torch.equal(torch.sort(idx[valid]).values, torch.arange(H_ * W_))
    with pytest.raises(ValueError, match="image has"):
        prm.tile_geometry(H_ * W_ + 1, (H_, W_))


@pytest.mark.parametrize("h,w,square", [(40, 512, False), (40, 512, True), (45, 500, True)],
                         ids=["strips", "square-tiles", "square-tiles-ragged"])
def test_tile_cull_is_conservative(scene, h, w, square):
    """No ray hits a body its tile culled: the cull cannot change a hit.
    At 40 x 512 a 256-ray strip is half a row, narrow enough to cull; 8x8
    pixel tiles are narrower still, and at 45 x 500 ragged on both edges."""
    _, (plib, pstate, pparams, penv) = scene
    K = _K(300.0, h, w)
    out = praymarch.render(plib, pstate, pparams, torch.from_numpy(K),
                           torch.from_numpy(top_camera()), h, w, env=penv)
    o, d_w, _ = _rays(K, h, w)
    hw = (h, w) if square else None
    radius_w = plib.radius[pparams.shape_id] * pparams.scale
    visidx, visn = prm.tile_visibility(torch.from_numpy(o), torch.from_numpy(d_w),
                                       pstate.pos, radius_w, pstate.active, hw)
    idx, valid = prm.tile_rays(*prm.tile_geometry(h * w, hw))
    seg = t2n(out["seg"]).reshape(-1)
    visidx, visn, idx, valid = t2n(visidx), t2n(visn), t2n(idx), t2n(valid)
    assert visn.min() < 3  # the cull removes something at this framing
    for k in range(idx.shape[0]):
        s = seg[idx[k][valid[k]]]
        assert set(np.unique(s[s >= 0])) <= set(visidx[k, :visn[k]].tolist())
        assert sorted(visidx[k]) == list(range(3))
