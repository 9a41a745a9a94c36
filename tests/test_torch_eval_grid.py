"""The pick-and-place checks of ``tests/test_torch_eval_loop.py`` on the
baked-grid path: a pile of 3 demo nuts (``assets/nut_demo.obj``) beside the
nut's default fixture, both baked at 56^3 on each side, settled on the grid
narrowphase and rendered through the grids by JAX; the port's scene is its
own ``setup_scene(obj_path=...)``.  The oracle pose, the scores, the order,
the pick gate's plans and schedule, and a short arm pick on the grid
narrowphase are held as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.geom.mesh import TriMesh as JTriMesh
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from test_torch_common import np_fields, t2n
from test_torch_eval_loop import (CANONICAL, FX, N_CODEBOOK, H, W, _check_pick_and_place_slice,
                                  _check_short_arm_pick)

torch.set_num_threads(2)
OBJ = "assets/nut_demo.obj"


@pytest.fixture(scope="module")
def grid_pile():
    can = dict(np.load(CANONICAL.format("nut")))
    cfg = dict(load_config("config_run.yml"), nocs_grasp_sampler_max_n_grasp=N_CODEBOOK)
    sc = rgs.setup_scene("nut", n_objects=3, cfg_run=cfg, render_hw=(H, W), canonical=can,
                         device="cpu", obj_path=OBJ)
    assert sc.geometry == "grid"
    sc.K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    m = JTriMesh.load_obj(OBJ)
    b = m.bounds
    meshes = [m, jprim.place_fixture("nut", None)]
    csgs = [jcsg.csg_box(b[1] - b[0], center=(b[1] + b[0]) / 2), jcsg.csg_place_fixture("nut", None)]
    lib = jbuild(meshes, csgs, n_surf=256, bake_grids=True, dims=56)
    # the port's own bake of the same meshes: the same grids, to f32 rounding
    np.testing.assert_allclose(t2n(sc.lib.sdf_values), np.asarray(lib.sdf_values), atol=2e-6)
    for k in ("surf_pts", "bounds", "csg.params"):
        obj = sc.lib
        for part in k.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(t2n(obj), np_fields(lib)[k], err_msg=k)
    n = sc.n_objects
    params = JSceneParams.create(lib, jnp.array([0] * n + [1], jnp.int32), jnp.ones(n + 1))
    params = params.replace(mass=params.mass.at[n].set(1e9),
                            inertia=params.inertia.at[n].set(1e9),
                            friction=params.friction.at[n].set(0.1))
    cfgp = jpile.PileConfig(max_bodies=n, scale_range=(0.9, 1.1))
    sp, _ = jpile.reset(jax.random.PRNGKey(7), lib, cfgp, n_objects=jnp.int32(n))
    state = JSceneState(
        pos=jnp.concatenate([sp.pos.at[:, 2].add(-0.05), jnp.asarray(rgs.FIXTURE_POS)[None]]),
        quat=jnp.concatenate([sp.quat, jnp.array([[1.0, 0, 0, 0]])]),
        linvel=jnp.zeros((n + 1, 3)), angvel=jnp.zeros((n + 1, 3)),
        active=jnp.ones(n + 1, bool))
    env = jarm.merge_envs(jengine.StaticEnv.open_bin(cfgp.bin_inner),
                          jengine.StaticEnv.boxes(jnp.array([[-0.1, -0.5, -0.006]]),
                                                  jnp.array([[0.15, 0.15, 0.005]])))
    for _ in range(60):
        state = jengine.step(state, params, lib, env, narrowphase="grid")
    out = jraymarch.render(lib, state, params, jnp.asarray(t2n(sc.K)), jnp.asarray(sc.cam),
                           H, W, env=env, geometry="grid")
    return sc, can, meshes, lib, state, params, env, {k: np.asarray(v) for k, v in out.items()}


def test_pick_and_place_slice_matches_jax_on_grid(grid_pile):
    _check_pick_and_place_slice(grid_pile)


def test_short_arm_pick_matches_jax_on_grid(grid_pile):
    _check_short_arm_pick(grid_pile, must_hold=True)
