"""Port parity: the renderer and kernel K2's plain march against JAX.

On the CPU the port marches with K2's plain version (every body, every
step, no culling), held to the JAX XLA-scan render and to the Pallas
``march_csg`` in interpret mode.  Legal divergences are f32 order of
operations, which moves a converged t by ~1e-7 and can flip a pixel on a
silhouette, so seg must agree on > 99.5% of pixels and depth to 2e-3 where
it does (the tolerances of ``tests/test_render_kernel.py``)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.ops import render_march as jrm
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu_torch.ops import render_march as prm
from catgrasp_tpu_torch.render import raymarch as praymarch
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


def test_plain_march_matches_pallas_interpret(scene):
    (lib, state, params, env), (plib, pstate, pparams, penv) = scene
    o, d_w, tmax = _rays()
    t_j = np.asarray(jrm.march_csg(lib, state, params, jnp.asarray(o), jnp.asarray(d_w),
                                   jnp.asarray(tmax), env=env, interpret=True))
    t_p = t2n(prm.march_csg_plain(plib, pstate, pparams, torch.from_numpy(o),
                                  torch.from_numpy(d_w), torch.from_numpy(tmax), env=penv))
    hit = (t_j < tmax * 0.999) & (t_p < tmax * 0.999)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(t_p[hit] * -d_w[hit, 2], t_j[hit] * -d_w[hit, 2], atol=2e-3)
    # misses agree too: a ray one side lets escape, the other does not stop
    assert ((t_j < tmax * 0.999) != (t_p < tmax * 0.999)).mean() < 0.005


def test_tile_cull_is_conservative(scene):
    """No ray hits a body its tile culled: the cull cannot change a hit.
    At 40 x 512 a 256-ray tile is half a row, narrow enough to cull."""
    _, (plib, pstate, pparams, penv) = scene
    h, w = 40, 512
    K = _K(300.0, h, w)
    out = praymarch.render(plib, pstate, pparams, torch.from_numpy(K),
                           torch.from_numpy(top_camera()), h, w, env=penv)
    o, d_w, _ = _rays(K, h, w)
    radius_w = plib.radius[pparams.shape_id] * pparams.scale
    visidx, visn = prm.tile_visibility(torch.from_numpy(o), torch.from_numpy(d_w),
                                       pstate.pos, radius_w, pstate.active)
    seg = t2n(out["seg"]).reshape(-1, prm.TILE)
    visidx, visn = t2n(visidx), t2n(visn)
    assert visn.min() < 3  # the cull removes something at this framing
    for k in range(seg.shape[0]):
        hit_bodies = set(np.unique(seg[k][seg[k] >= 0]))
        assert hit_bodies <= set(visidx[k, :visn[k]].tolist())
        assert sorted(visidx[k]) == list(range(3))
