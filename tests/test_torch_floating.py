"""Port parity for the floating-gripper baseline: the in-pile pick
(``pipelines/run_grasp_simulation.py:execute_pick``) and the fixture-world
place (``sim/env_semantic.py:place_and_drop``).

``place_and_drop`` is held on the three cases of ``tests/test_semantic.py``
(a good grasp, a grasp whose palm blocks the insertion, in-hand slip that
tilts the drop): the same booleans.  ``execute_pick`` runs with short
schedules patched into both packages (45 close, 15 hold steps) on a pile
JAX settles, for a grasp across a nut and a grasp on air: the same
``picked``, the target's pose within 1e-4 m and the width within 1e-4 m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.pipelines import run_grasp_simulation as jrgs
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim import env_semantic as jes
from catgrasp_tpu.sim.env_grasp import GripperSpec as JSpec
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from catgrasp_tpu_torch.sim import env_semantic as es
from catgrasp_tpu_torch.sim.env_grasp import GripperSpec
from test_torch_common import port_env, port_lib, port_params, port_state, t2n

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture_lib():
    """The library of ``tests/test_semantic.py``: a nut and the nut fixture."""
    meshes = [jprim.make_instance("nut", "train", 0), jprim.place_fixture("nut")]
    csgs = [jcsg.make_csg_instance("nut", "train", 0), jcsg.csg_place_fixture("nut")]
    return jbuild(meshes, csgs, n_surf=64)


def _grasp(approach, closing, z):
    G = np.eye(4, dtype=np.float32)
    G[:3, 0], G[:3, 1] = approach, closing
    G[:3, 2] = np.cross(G[:3, 0], G[:3, 1])
    G[2, 3] = z
    return G


def _side_pinch():
    """Approach -z (from above, the nut upright at its task orientation),
    closing along x, tips at mid-height."""
    return _grasp([0, 0, -1], [1, 0, 0], GripperSpec().finger_len)


def _tilted(G, deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    R = np.eye(4, dtype=np.float32)
    R[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return (G @ R).astype(np.float32)


CASES = {
    # (actual grasp in the object, commanded grasp in the object or None)
    "good grasp": (_side_pinch(), None),
    # palm below the object, fingers up through the peg: blocks the sweep
    "blocking grasp": (_grasp([0, 0, 1], [1, 0, 0], -GripperSpec().finger_len), None),
    # the actual grasp 35 deg off the commanded: the nut hangs tilted
    "in-hand slip": (_tilted(_side_pinch(), 35.0), _side_pinch()),
}
EXPECTED = {"good grasp": True, "blocking grasp": False, "in-hand slip": False}


@pytest.mark.parametrize("case", list(CASES))
def test_place_and_drop_matches_jax(fixture_lib, case):
    G, cmd = CASES[case]
    j = jes.place_and_drop(fixture_lib, jnp.int32(0), jnp.int32(1), jnp.float32(1.0),
                           jnp.asarray(G), "nut", jnp.float32(0.021), JSpec(),
                           grasp_in_ob_cmd=None if cmd is None else jnp.asarray(cmd))
    p = es.place_and_drop(port_lib(fixture_lib), torch.tensor(0), 1, torch.tensor(1.0),
                          torch.as_tensor(G), "nut", torch.tensor(0.021), GripperSpec(),
                          grasp_in_ob_cmd=None if cmd is None else torch.as_tensor(cmd))
    assert p.dtype == torch.bool and p.shape == ()
    assert bool(j) == EXPECTED[case]
    assert bool(p) == bool(j)


def test_gripper_sample_points_match_jax():
    w = 0.021
    j = np.asarray(jes._gripper_sample_points(JSpec(), jnp.float32(w), n_boxes=3))
    p = t2n(es._gripper_sample_points(GripperSpec(), torch.tensor(w)))
    np.testing.assert_allclose(p, j, atol=1e-7)


@pytest.fixture(scope="module")
def pile():
    """Two nuts dropped by JAX and settled 150 steps on the bin floor."""
    lib = jbuild([jprim.make_instance("nut", "test", 0)],
                 [jcsg.make_csg_instance("nut", "test", 0)], n_surf=96)
    cfg = jpile.PileConfig(max_bodies=2)
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    sp, params = jpile.reset(jax.random.PRNGKey(1), lib, cfg, n_objects=jnp.int32(2))
    state = jengine.rollout(sp, params, lib, env, 150)
    return lib, state, params, env


def _top_down_grasp(state, target, offset=(0.0, 0.0)):
    """Approach straight down, closing along world x, the object 2 cm into
    the fingers."""
    g = _grasp([0, 0, -1], [1, 0, 0], 0.0)
    g[:3, 3] = np.asarray(state.pos[target])
    g[:2, 3] += offset
    g[2, 3] += 0.02
    return g


@pytest.mark.parametrize("where", ["on the nut", "on air"])
def test_execute_pick_matches_jax(pile, monkeypatch, where):
    lib, state, params, env = pile
    for mod in (jrgs, rgs):
        monkeypatch.setattr(mod, "CLOSE_STEPS", 45)
        monkeypatch.setattr(mod, "LIFT_STEPS", 15)
    G = _top_down_grasp(state, 0, (0.0, 0.0) if where == "on the nut" else (0.0, 0.045))
    pick_j = jax.jit(jrgs.execute_pick, static_argnames=("spec", "narrowphase"))
    pj, fj, oj, wj = pick_j(lib, state, params, env, jnp.int32(0), jnp.asarray(G), JSpec())
    pp, fp, op, wp = rgs.execute_pick(port_lib(lib), port_state(state), port_params(params),
                                      port_env(env), 0, torch.as_tensor(G), GripperSpec())
    assert bool(pj) == (where == "on the nut")
    assert bool(pp) == bool(pj)
    np.testing.assert_allclose(t2n(fp.pos)[0], np.asarray(fj.pos)[0], atol=1e-4)
    np.testing.assert_allclose(t2n(op)[:3, 3], np.asarray(oj)[:3, 3], atol=1e-4)
    assert abs(float(wp) - float(wj)) <= 1e-4


def test_floating_attempt_matches_jax_loop():
    """The floating baseline's attempt as the JAX loop composes it
    (``run_grasp_simulation.py:745,792,810-819``), on the eval harness's
    nut pile (``tests/test_torch_eval_loop.py``): candidates in score order
    (the loop takes the first), each executed by the floating gripper with
    the full close and hold, until one holds; that one is placed by
    ``place_and_drop`` with the actual in-hand pose and the commanded grasp.
    Held for every candidate tried: ``picked`` equal, the width within 1e-4
    m, the object in the grasp frame within 1 mm; then ``placed`` equal."""
    from catgrasp_tpu.core import transforms as jtf
    from test_torch_eval_loop import _jax_candidates, _jax_scores, _pile

    sc, can, meshes, lib, state, params, env, out = _pile("nut")
    rng = np.random.default_rng(0)
    target, m, pts, nrm, bg_m, nocs, grasps_cam = _jax_candidates(
        sc, can, meshes, state, params, out, rng)
    if len(grasps_cam) > rgs.MAX_CANDIDATES:
        grasps_cam = grasps_cam[rng.choice(len(grasps_cam), rgs.MAX_CANDIDATES, replace=False)]
    order = _jax_scores(can, nocs, pts, nrm, grasps_cam)[4]
    pick_j = jax.jit(jrgs.execute_pick, static_argnames=("spec", "narrowphase"))
    ps, pp = port_state(state), port_params(params)
    for i in order[:6]:
        grasp_world = (sc.cam @ grasps_cam[i]).astype(np.float32)
        pj, _, oj, wj = pick_j(lib, state, params, env, jnp.int32(target),
                               jnp.asarray(grasp_world), JSpec())
        gw = torch.as_tensor(grasp_world)
        picked, _, op, wp = rgs.execute_pick(sc.lib, ps, pp, sc.env_bin, target, gw,
                                             sc.gripper.spec)
        assert bool(picked) == bool(pj)
        assert abs(float(wp) - float(wj)) <= 1e-4
        np.testing.assert_allclose(t2n(op)[:3, 3], np.asarray(oj)[:3, 3], atol=1e-3)
        if bool(pj):
            break
    assert bool(pj), "no candidate of the first 6 held in the JAX floating pick"
    cmd_j = jtf.pose_inverse(jtf.pose_from_qt(state.quat[target], state.pos[target])) \
        @ jnp.asarray(grasp_world)
    placed_j = jes.place_and_drop(lib, params.shape_id[target], jnp.int32(sc.fixture_idx),
                                  params.scale[target], jtf.pose_inverse(oj), "nut", wj,
                                  JSpec(), grasp_in_ob_cmd=cmd_j)
    placed_p = rgs.place_floating(sc, ps, pp, target, op, wp, gw)
    assert bool(placed_p) == bool(placed_j)
