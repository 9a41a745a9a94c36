"""Port parity: the contact engine against ``catgrasp_tpu.sim.engine``.

Physics is chaotic, so trajectories are held only over a short horizon:
20 steps from the same JAX pile reset (3 nuts in the bin), positions within
1 mm and quaternions within 0.01.  The JAX step is jitted once and looped
(one compile, not a compiled scan per horizon)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.sim import arm as parm
from catgrasp_tpu_torch.sim import engine as pengine
from catgrasp_tpu_torch.sim import env_pile as ppile
from test_torch_common import CPU, np_fields, port_env, port_lib, port_params, port_state, t2n

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pile():
    """A JAX pile reset of 3 nuts plus the nut fixture (a static body), in
    the bin merged with a table slab — the eval's collider set."""
    fit = jprim.instance_params("nut", "test", 0)
    meshes = [jprim.make_instance("nut", "test", 0), jprim.place_fixture("nut", fit)]
    csgs = [jcsg.make_csg_instance("nut", "test", 0), jcsg.csg_place_fixture("nut", fit)]
    lib = jbuild(meshes, csgs, n_surf=32)
    cfg = jpile.PileConfig(max_bodies=3)
    state, params = jpile.reset(jax.random.PRNGKey(3), lib, cfg, n_objects=jnp.int32(3))
    # drop the column lower so contacts start within the horizon
    state = state.replace(pos=state.pos.at[:, 2].add(-0.05))
    env = jarm.merge_envs(jengine.StaticEnv.open_bin(cfg.bin_inner),
                          jengine.StaticEnv.boxes(jnp.array([[-0.1, -0.5, -0.006]]),
                                                  jnp.array([[0.15, 0.15, 0.005]])))
    return lib, cfg, state, params, env


def test_step_trajectory_matches_jax(pile):
    lib, cfg, state, params, env = pile
    p_lib, p_env = port_lib(lib), port_env(env)
    p_state, p_params = port_state(state), port_params(params)
    step = jax.jit(jengine.step)
    n_contact = 0
    for _ in range(20):
        state = step(state, params, lib, env)
        p_state = pengine.step(p_state, p_params, p_lib, p_env)
    dp = np.abs(t2n(p_state.pos) - np.asarray(state.pos)).max()
    dq = np.abs(t2n(p_state.quat) - np.asarray(state.quat)).max()
    assert dp < 1e-3, f"max position divergence {dp * 1e3:.3f} mm"
    assert dq < 0.01, f"max quaternion divergence {dq}"
    # the horizon must include contact: something was pushed off free fall
    free_fall_v = 9.8 * 20 * jengine.DT * (1 - 0.0095) ** 10
    n_contact = int((np.abs(np.asarray(state.linvel)[:, 2]) < 0.9 * free_fall_v).sum())
    assert n_contact > 0


def test_static_fixture_and_cull_match_jax(pile):
    """A static (mass >= STATIC_MASS) body never moves, and the settle's
    out-of-bin cull deactivates what left the bin, as in JAX."""
    lib, cfg, state, params, env = pile
    pos = state.pos.at[2].set(jnp.array([0.5, 0.0, 0.05]))  # outside the bin
    state = state.replace(pos=pos)
    params = params.replace(mass=params.mass.at[0].set(1e9))
    j = jpile.settle_fixed(state, params, lib, env, cfg, 3)
    p = ppile.settle_fixed(port_state(state), port_params(params), port_lib(lib),
                           port_env(env), cfg, 3)
    np.testing.assert_array_equal(t2n(p.active), np.asarray(j.active))
    assert not bool(j.active[2])
    np.testing.assert_array_equal(t2n(p.pos[0]), np.asarray(state.pos[0]))
    np.testing.assert_allclose(t2n(p.pos), np.asarray(j.pos), atol=1e-3)
    np.testing.assert_allclose(float(pengine.max_body_motion(port_state(state), p)),
                               float(jengine.max_body_motion(state, j)), atol=1e-3)


def test_env_builders_match_jax():
    j = jarm.merge_envs(jengine.StaticEnv.open_bin((0.3, 0.3, 0.12)),
                        jengine.StaticEnv.boxes(jnp.array([[-0.1, -0.5, -0.006]]),
                                                jnp.array([[0.15, 0.15, 0.005]])))
    p = parm.merge_envs(pengine.StaticEnv.open_bin((0.3, 0.3, 0.12), device=CPU),
                        pengine.StaticEnv.boxes([[-0.1, -0.5, -0.006]],
                                                [[0.15, 0.15, 0.005]], device=CPU))
    for k, v in np_fields(j).items():
        np.testing.assert_array_equal(t2n(getattr(p, k)), v, err_msg=k)


def test_port_reset_draws_a_valid_pile():
    """The port's reset draws from a torch.Generator (JAX's key stream
    cannot be reproduced); it must give the same layout rules."""
    meshes = [jprim.make_instance("nut", "test", 0)]
    from catgrasp_tpu_torch.geom import csg as pcsg
    from catgrasp_tpu_torch.geom import primitives as pprim
    from catgrasp_tpu_torch.sim.types import build_shape_lib as pbuild
    lib = pbuild([pprim.make_instance("nut", "test", 0)],
                 [pcsg.make_csg_instance("nut", "test", 0)], n_surf=16, device=CPU)
    cfg = ppile.PileConfig(max_bodies=4)
    g = torch.Generator().manual_seed(0)
    st, params = ppile.reset(g, lib, cfg, n_objects=3)
    assert t2n(st.active).tolist() == [True, True, True, False]
    assert np.all(np.abs(t2n(st.pos[:, :2])) <= 0.06)
    np.testing.assert_allclose(t2n(st.pos[:, 2]), 0.06 + 0.035 * np.arange(4), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(t2n(st.quat), axis=1), 1.0, atol=1e-6)
    assert len(meshes) == 1 and t2n(params.scale).min() >= 0.75
