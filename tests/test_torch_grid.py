"""Port parity for the grid geometry path: the grid narrowphase of
``sim/engine.py`` (one engine step) and ``render(geometry="grid")``.

Both sides run on JAX's own library (CSG trees and baked grids), carried
across by ``convert.py``, from the same state.  One step is held within
1e-5; the render is held as ``tests/test_torch_render.py`` holds the CSG
render: seg equal on > 99.5% of pixels, depth within 2e-3 m where seg
agrees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.render import raymarch
from catgrasp_tpu_torch.sim import engine
from test_torch_common import port_env, port_lib, port_params, port_state, t2n, top_camera

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    """A nut, a screw and an hnm with baked grids (dims 40), reset by JAX
    into the bin and stepped 120 times on the grid narrowphase, so that they
    touch the floor and each other."""
    classes = ("nut", "screw", "hnm")
    meshes = [jprim.make_instance(c, "train", 0) for c in classes]
    csgs = [jcsg.make_csg_instance(c, "train", 0) for c in classes]
    lib = jbuild(meshes, csgs, n_surf=48, dims=40, bake_grids=True)
    cfg = jpile.PileConfig(max_bodies=4)
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    state, params = jpile.reset(jax.random.PRNGKey(3), lib, cfg, n_objects=jnp.int32(4))
    state = jengine.rollout(state, params, lib, env, 120, narrowphase="grid")
    return lib, state, params, env


def test_grid_step_matches_jax(scene):
    lib, state, params, env = scene
    pj = jengine.step(state, params, lib, env, narrowphase="grid")
    pp = engine.step(port_state(state), port_params(params), port_lib(lib), port_env(env),
                     narrowphase="grid")
    active = np.asarray(state.active)
    assert active.sum() >= 3
    for f in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(t2n(getattr(pp, f))[active],
                                   np.asarray(getattr(pj, f))[active], atol=1e-5, err_msg=f)
    # the grid step is not the CSG step: the narrowphase really changed
    pc = engine.step(port_state(state), port_params(params), port_lib(lib), port_env(env))
    assert not torch.allclose(pc.linvel, pp.linvel, atol=1e-6)


def test_grid_narrowphase_needs_baked_grids(scene):
    lib, state, params, env = scene
    bare = port_lib(lib)
    bare.sdf_values = None
    with pytest.raises(ValueError, match="bake_grids"):
        engine.step(port_state(state), port_params(params), bare, port_env(env),
                    narrowphase="grid")
    with pytest.raises(ValueError, match="narrowphase"):
        engine.step(port_state(state), port_params(params), bare, port_env(env),
                    narrowphase="mesh")


def test_grid_render_matches_jax(scene):
    lib, state, params, env = scene
    H, W = 48, 64
    K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]], np.float32)
    cam = top_camera(0.2)
    cam[:2, 3] = np.asarray(state.pos)[:, :2].mean(axis=0)  # over the bodies
    oj = jraymarch.render(lib, state, params, jnp.asarray(K), jnp.asarray(cam), H, W, env=env,
                          geometry="grid")
    op = raymarch.render(port_lib(lib), port_state(state), port_params(params),
                         torch.as_tensor(K), torch.as_tensor(cam), H, W, env=port_env(env),
                         geometry="grid")
    seg_j, seg_p = np.asarray(oj["seg"]), t2n(op["seg"])
    assert (seg_j >= 0).sum() > 100, "the bodies should be in view"
    assert (seg_p == seg_j).mean() > 0.995
    both = (seg_p == seg_j) & (seg_j != -1)
    np.testing.assert_allclose(t2n(op["depth"])[both], np.asarray(oj["depth"])[both], atol=2e-3)
    obj = both & (seg_j >= 0)
    cos = np.sum(t2n(op["normal"])[obj] * np.asarray(oj["normal"])[obj], axis=-1)
    assert np.median(cos) > 0.999
    # the grid render is not the CSG render
    oc = raymarch.render(port_lib(lib), port_state(state), port_params(params),
                         torch.as_tensor(K), torch.as_tensor(cam), H, W, env=port_env(env))
    assert not torch.equal(oc["depth"], op["depth"])
