"""Port parity for the place gate of the arm-executed eval:
``plan_place`` + ``execute_place`` against the JAX loop's
``_place_with_arm`` (``catgrasp_tpu/pipelines/run_grasp_simulation.py``),
for the three categories (12, 72 and 2 symmetries) with the fallback ladder
on, as both loops run it by default.

The JAX function returns only ``placed``; its gate is read from a trace of
the calls it makes (each ``ik_best``, each descent plan, each RRT plan and
the schedule it executes), decoded with the gate's own rules.  Both sides
start from one fixed ``ob_in_grasp`` and ``q_cur`` (a tool pose over the
bin) and one obstacle cloud.  Held equal: the symmetry taken, every
``fails`` counter and ``placed``; the schedule within 1e-4 rad, as the pick
plans are held in ``tests/test_torch_eval_loop.py`` (an IK solution near a
wrist or shoulder singularity may differ by up to 2e-4 rad; the candidates
here are clear of them).  The executed place is shortened in both packages
alike (20 transport, 40 insertion, 50 drop steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.kin import iiwa as jiiwa
from catgrasp_tpu.kin import planner as jplanner
from catgrasp_tpu.pipelines import run_grasp_simulation as jrgs
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from test_torch_common import port_params, port_state, t2n

torch.set_num_threads(2)
FAIL_KEYS = ("ik_pre", "ik_place", "descent", "rrt", "relax_start", "relax_goal", "relax_iter")
N_MOVE, N_DROP = 60, 50


def _jax_world(sc):
    """The JAX library, parameters and env of the port's scene ``sc`` (one
    object and the fixture), built from the same meshes."""
    cls = sc.class_name
    fit = jprim.instance_params(cls, "test", sc.instance)
    meshes = [jprim.make_instance(cls, "test", i) for i in range(sc.n_inst)]
    csgs = [jcsg.make_csg_instance(cls, "test", i) for i in range(sc.n_inst)]
    lib = jbuild(meshes + [jprim.place_fixture(cls, fit)],
                 csgs + [jcsg.csg_place_fixture(cls, fit)], n_surf=256)
    params = JSceneParams.create(lib, jnp.array([sc.instance, sc.fixture_idx], jnp.int32),
                                 jnp.ones(2))
    params = params.replace(mass=params.mass.at[1].set(1e9),
                            inertia=params.inertia.at[1].set(1e9),
                            friction=params.friction.at[1].set(0.1))
    env = jarm.merge_envs(jengine.StaticEnv.open_bin(sc.pile_cfg.bin_inner),
                          jengine.StaticEnv.boxes(jnp.array([[-0.1, -0.5, -0.006]]),
                                                  jnp.array([[0.15, 0.15, 0.005]])))
    return lib, params, env


def _inputs(sc):
    """q_cur: the arm's IK for a tool pose 0.28 m over the bin centre,
    pointing down; ob_in_grasp: the object 2 cm into the fingers, its z axis
    against the approach; the obstacles: the fixture, a cloud in the bin
    and a blob at the wrist, which blocks the observed-cloud planner at its
    start, so that every orientation goes down the ladder to the planner
    without obstacles."""
    g = JGripper.default()
    G = np.eye(4, dtype=np.float32)
    G[:3, 0], G[:3, 1] = [0, 0, -1], [1, 0, 0]
    G[:3, 2] = np.cross(G[:3, 0], G[:3, 1])
    G[:3, 3] = [0.01, -0.02, 0.28]
    ee = (np.linalg.inv(sc.base_in_world) @ G @ np.asarray(g.ee_in_grasp)).astype(np.float32)
    q_cur, ok = jiiwa.ik_best(jnp.asarray(ee))
    assert bool(ok)
    oig = np.eye(4, dtype=np.float32)
    oig[:3, :3] = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], np.float32)
    oig[:3, 3] = [0.02, 0.0, 0.0]
    rng = np.random.default_rng(4)
    cloud = np.concatenate([rng.uniform(-0.1, 0.1, (300, 2)), rng.uniform(0, 0.04, (300, 1))], 1)
    wrist = G[:3, 3] - 0.12 * G[:3, 0] + rng.uniform(-0.02, 0.02, (40, 3))
    obs = np.concatenate([cloud - sc.base_in_world[:3, 3], wrist - sc.base_in_world[:3, 3],
                          sc.fix_pts_base]).astype(np.float32)
    return np.asarray(q_cur, np.float32), oig, obs, G


def _decode(trace, n_sym):
    """The JAX gate's symmetry and ``fails`` counters from its call trace."""
    fails = dict.fromkeys(FAIL_KEYS, 0)
    ev = iter(trace)
    pending = []

    def nxt():
        return pending.pop() if pending else next(ev, None)

    for s in range(n_sym):
        kind, ok = nxt()[:2]
        assert kind == "ik"
        if not ok:
            fails["ik_pre"] += 1
            continue
        kind, ok = nxt()[:2]
        if not ok:
            fails["ik_place"] += 1
            continue
        while True:  # the branches
            e = nxt()
            if e is None or e[0] != "descent":
                if e is not None:
                    pending.append(e)
                break
            if not e[1]:
                fails["descent"] += 1
                break
            e = nxt()
            assert e[0] == "rrt" and e[2] == "obs"
            if e[1]:
                return s, fails
            e = nxt()
            assert e[0] == "rrt" and e[2] == "free"
            if e[1]:
                return s, fails
            sg = e[3]
            fails["relax_start" if not sg[0] else ("relax_goal" if not sg[1] else
                                                   "relax_iter")] += 1
            fails["rrt"] += 1
    return None, fails


@pytest.mark.parametrize("cls", ["nut", "screw", "hnm"])
def test_place_gate_matches_jax(cls, monkeypatch):
    for mod in (jrgs, rgs):
        monkeypatch.setattr(mod, "N_MOVE_P", N_MOVE)
        monkeypatch.setattr(mod, "N_DROP_P", N_DROP)
    monkeypatch.delenv("CATGRASP_PLACE_FALLBACKS", raising=False)
    sc = rgs.setup_scene(cls, n_objects=1, render_hw=(8, 8), device="cpu")
    q_cur, oig, obs, G = _inputs(sc)
    lib, params, env = _jax_world(sc)
    ob0 = G @ oig
    state = JSceneState(
        pos=jnp.asarray(np.stack([ob0[:3, 3], rgs.FIXTURE_POS])),
        quat=jnp.stack([jnp.asarray(jrgs.tf.matrix_to_quat(jnp.asarray(ob0[:3, :3]))),
                        jnp.array([1.0, 0, 0, 0])]),
        linvel=jnp.zeros((2, 3)), angvel=jnp.zeros((2, 3)), active=jnp.ones(2, bool))

    # --- JAX, traced ---
    trace, scheds = [], []
    ik_best, plan_cart = jiiwa.ik_best, jplanner.plan_cartesian_waypoints

    def ik_best_rec(ee):
        q, ok = ik_best(ee)
        trace.append(("ik", bool(ok)))
        return q, ok

    def plan_cart_rec(poses, q_seed):
        qs, ok = plan_cart(poses, q_seed=q_seed)
        trace.append(("descent", bool(ok)))
        return qs, ok

    class RRTRec(jplanner.RRTConnect):
        def plan(self, start, goal, max_iter=500):
            path = super().plan(start, goal, max_iter=max_iter)
            tag = "free" if self.floor_z < -1.0 else "obs"
            sg = (None if path is not None or tag == "obs"
                  else jplanner.RRTConnect._free(self, np.stack([np.asarray(start), goal])))
            trace.append(("rrt", path is not None, tag, sg))
            return path

    execute = jarm.execute_place_arm

    def execute_rec(*args, **kw):
        scheds.append(np.asarray(args[5]))
        return execute(*args, **kw)

    monkeypatch.setattr(jrgs.iiwa, "ik_best", ik_best_rec)
    monkeypatch.setattr(jrgs.planner, "plan_cartesian_waypoints", plan_cart_rec)
    monkeypatch.setattr(jrgs.planner, "RRTConnect", RRTRec)
    monkeypatch.setattr(jrgs.simarm, "execute_place_arm", execute_rec)
    g = JGripper.default()
    placed_j, _ = jrgs._place_with_arm(
        lib, state, params, env, 0, oig, jnp.float32(0.02), q_cur, sc.base_in_world, g,
        sc.T_fix, cls, sc.sym, obs, 0, g.spec, False)
    monkeypatch.undo()
    for mod in (jrgs, rgs):
        monkeypatch.setattr(mod, "N_MOVE_P", N_MOVE)
        monkeypatch.setattr(mod, "N_DROP_P", N_DROP)
    sym_j, fails_j = _decode(trace, len(sc.sym))

    # --- the port ---
    sched_p, gate = rgs.plan_place(sc, oig, q_cur, obs, 0)
    assert gate["sym"] == sym_j and gate["fails"] == fails_j, (gate, sym_j, fails_j)
    assert sym_j is not None, f"no orientation placed: {fails_j}"
    assert len(scheds) == 1 and sched_p.shape == scheds[0].shape == (N_MOVE + N_DROP, 7)
    np.testing.assert_allclose(sched_p, scheds[0], atol=1e-4)
    placed_p, _ = rgs.execute_place(sc, port_state(state), port_params(params), 0, sched_p,
                                    torch.as_tensor(oig), torch.tensor(0.02), torch.tensor(0.0))
    assert placed_p == bool(placed_j)
    # the wrist blob sends every orientation down the ladder
    assert ("rrt", False, "obs", None) in trace
