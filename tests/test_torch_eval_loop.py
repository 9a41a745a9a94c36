"""Port parity for the pick-and-place half of the eval as a whole, and a
one-round smoke of the port's ``simulate_grasp_rounds``.

The JAX side mirrors ``catgrasp_tpu/pipelines/run_grasp_simulation.py``
lines 556-743 inline with the JAX package's functions (the loop has no
smaller entry points); the port side calls its own ``oracle_nocs_pose``,
``score_candidates``, ``obstacles_in_base``, ``plan_pick`` and
``pick_schedule``.  Both start from one pile the JAX side settles and
renders, and from the same candidate set: the JAX NOCS-transfer sampler's
valid candidates (its plain "xla" collision path) on that render.  Numpy
draws are made from one seed in the loop's order on both sides.

IK candidates agree within 1e-4 rad (``test_torch_pickplace.py``), so the
plans and schedules, which start and end at IK solutions, are held within
1e-4 rad; the pick and the order are held equal.  The nut harness is the
tests without a class in their name; the screw and hnm harnesses run the
same checks on their own pile (the hnm pile is ``PRNGKey(5)``, not ``PRNGKey(7)``: on the latter's
largest segment there JAX's NOCS sampler keeps no candidate).

The modes beyond the arm-executed CSG loop run in
``tests/test_torch_eval_modes.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.core.symmetry import get_symmetry_tfs
from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.grasp import filter as jfilter
from catgrasp_tpu.grasp import quality as jquality
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.grasp.sampler import NocsTransferGraspSampler as JNocs
from catgrasp_tpu.kin import iiwa as jiiwa
from catgrasp_tpu.kin import planner as jplanner
from catgrasp_tpu.pipelines import run_grasp_simulation as jrgs
from catgrasp_tpu.pipelines.make_canonical import to_nunocs_transform
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from test_torch_common import port_params, port_state, t2n

torch.set_num_threads(2)
H, W, FX = 96, 128, 300.0  # zoomed in so that each nut covers a few hundred pixels
CANONICAL = "dataset/{}_canonical.npz"
N_CODEBOOK = 1024  # the canonical's best grasps the samplers start from
# the pile of each class's harness: the nut's, and for screw and hnm a key
# on whose pile JAX's NOCS sampler keeps candidates on the largest segment
PILE_KEY = {"nut": 7, "screw": 7, "hnm": 5}


def _pile(cls, hw=(H, W), fx=FX):
    """A 3-object pile of ``cls`` plus its fixture in the eval's set-up (the
    port's own), reset and stepped 60 times by JAX, then rendered by JAX at
    ``hw`` with focal length ``fx``."""
    H, W = hw
    can = dict(np.load(CANONICAL.format(cls)))
    cfg = dict(load_config("config_run.yml"), nocs_grasp_sampler_max_n_grasp=N_CODEBOOK)
    sc = rgs.setup_scene(cls, n_objects=3, cfg_run=cfg, render_hw=(H, W), canonical=can,
                         device="cpu")
    sc.K = torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    fit = jprim.instance_params(cls, "test", 0)
    meshes = [jprim.make_instance(cls, "test", i) for i in range(sc.n_inst)]
    meshes.append(jprim.place_fixture(cls, fit))
    csgs = [jcsg.make_csg_instance(cls, "test", i) for i in range(sc.n_inst)]
    lib = jbuild(meshes, csgs + [jcsg.csg_place_fixture(cls, fit)], n_surf=256)
    n = sc.n_objects
    params = JSceneParams.create(lib, jnp.array([0] * n + [sc.fixture_idx], jnp.int32),
                                 jnp.ones(n + 1))
    params = params.replace(mass=params.mass.at[n].set(1e9),
                            inertia=params.inertia.at[n].set(1e9),
                            friction=params.friction.at[n].set(0.1))
    cfgp = jpile.PileConfig(max_bodies=n, scale_range=(0.9, 1.1))
    sp, _ = jpile.reset(jax.random.PRNGKey(PILE_KEY[cls]), lib, cfgp, n_objects=jnp.int32(n))
    state = JSceneState(
        pos=jnp.concatenate([sp.pos.at[:, 2].add(-0.05), jnp.asarray(rgs.FIXTURE_POS)[None]]),
        quat=jnp.concatenate([sp.quat, jnp.array([[1.0, 0, 0, 0]])]),
        linvel=jnp.zeros((n + 1, 3)), angvel=jnp.zeros((n + 1, 3)),
        active=jnp.ones(n + 1, bool))
    env = jarm.merge_envs(jengine.StaticEnv.open_bin(cfgp.bin_inner),
                          jengine.StaticEnv.boxes(jnp.array([[-0.1, -0.5, -0.006]]),
                                                  jnp.array([[0.15, 0.15, 0.005]])))
    step = jax.jit(jengine.step)
    for _ in range(60):
        state = step(state, params, lib, env)
    out = jraymarch.render(lib, state, params, jnp.asarray(t2n(sc.K)), jnp.asarray(sc.cam),
                           H, W, env=env)
    return sc, can, meshes, lib, state, params, env, {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def pile():
    return _pile("nut")


@pytest.fixture(scope="module", params=["screw", "hnm"])
def class_pile(request):
    return _pile(request.param)


def _jax_candidates(sc, can, meshes, state, params, out, rng):
    """The JAX loop's segment body (oracle, NOCS transfer) on the largest
    segment: (target, mask, pts, nrm, bg_m, nocs_pose, grasps_cam)."""
    seg, xyz, normal = out["seg"], out["xyz"], out["normal"]
    target = max(range(sc.n_objects), key=lambda i: (seg == i).sum())
    m = seg == target
    pts, nrm = xyz[m], normal[m]
    bg_m = ~m & (seg != -1)
    bg = xyz[bg_m]
    T_wc = np.linalg.inv(sc.cam)
    ob_in_cam = T_wc @ np.asarray(jtf.pose_from_qt(state.quat[target], state.pos[target]))
    T_nocs = to_nunocs_transform(meshes[int(params.shape_id[target])].vertices
                                 * float(params.scale[target]))
    nocs_pose = (ob_in_cam @ np.linalg.inv(T_nocs)).astype(np.float32)
    n_sub = min(len(pts), rgs.MAX_COLLISION_PTS)
    ids = rng.choice(len(pts), n_sub, replace=False)
    sampler = JNocs(JGripper.default(), can["canonical_grasps"], can["canonical_grasp_scores"],
                    score_larger_than=0.95, max_n_grasp=N_CODEBOOK)
    poses, valid, _ = sampler.sample_grasps(
        jnp.asarray(nocs_pose), jnp.asarray(get_symmetry_tfs(sc.class_name)), bg,
        np.ones(len(bg), bool), pts[ids], np.ones(n_sub, bool),
        cam_in_world=jnp.asarray(t2n(sc.cam_in_base)), filter_ik=True, chunk=128,
        adjust_depth=True, backend="xla")
    grasps_cam = np.asarray(poses)[np.asarray(valid)]
    return target, m, pts, nrm, bg_m, nocs_pose, grasps_cam


def _jax_scores(can, nocs_pose, pts, nrm, grasps_cam):
    """Lines 621-671: P(T|G), P(G), the thresholds and the order."""
    g = JGripper.default()
    p_T_given_G = jrgs.grasp_affordance(can, nocs_pose, grasps_cam, width=0.012, spec=g.spec)
    q = np.asarray(jquality.parallel_jaw_quality(jnp.asarray(pts), jnp.asarray(nrm),
                                                 jnp.asarray(grasps_cam), g.spec))
    p_G = np.clip(q / 0.3, 0.0, 1.0).astype(np.float32)
    p_T_G = p_T_given_G * p_G
    ok = (p_G >= 0.5) & (p_T_given_G >= 0.5) & (p_T_G >= 0.1)
    if not ok.any():
        ok = p_T_G >= 0
    eng = np.asarray(jfilter.engagement_depth(jnp.asarray(pts), jnp.asarray(grasps_cam),
                                              g.spec))
    viable = eng >= 0.08
    srt = np.lexsort((-eng, -np.round(p_T_G, 2), ~viable))
    ok = ok & viable
    order = [i for i in srt if ok[i]] + [i for i in srt if not ok[i]]
    return p_T_given_G, p_G, eng, ok, order


def _jax_plan(sc, grasps_cam, order, obs_base, seed):
    """Lines 690-734: the pick gate over the first 12 candidates."""
    g = JGripper.default()
    base_in_world = sc.base_in_world
    rrt = jplanner.RRTConnect(obs_base.astype(np.float32), floor_z=-0.04, seed=seed)
    for i in order[:12]:
        g_base = (np.linalg.inv(base_in_world) @ sc.cam @ grasps_cam[i]).astype(np.float32)
        pre = g_base.copy()
        pre[:3, 3] -= 0.10 * pre[:3, 0]
        ee_pre = pre @ np.asarray(g.ee_in_grasp)
        ee_goal = g_base @ np.asarray(g.ee_in_grasp)
        q_pre, found_pre = jiiwa.ik_best(jnp.asarray(ee_pre))
        _, found_g = jiiwa.ik_best(jnp.asarray(ee_goal))
        if not (bool(found_pre) and bool(found_g)):
            continue
        descent = np.stack([ee_pre * (1 - a) + ee_goal * a for a in np.linspace(0, 1, 5)])
        qs_d, ok_d = jplanner.plan_cartesian_waypoints(descent, q_seed=np.asarray(q_pre))
        if not ok_d:
            continue
        ee_lift = ee_goal.copy()
        ee_lift[:3, 3] += [0.0, 0.0, jrgs.LIFT_HEIGHT]
        lift = np.stack([ee_goal * (1 - a) + ee_lift * a for a in np.linspace(0, 1, 5)])
        qs_l, ok_l = jplanner.plan_cartesian_waypoints(lift, q_seed=qs_d[-1])
        if not ok_l:
            continue
        path = rrt.plan(jrgs.Q_HOME, np.asarray(q_pre), max_iter=500)
        if path is not None:
            return i, (np.stack(path), qs_d, qs_l)
    return None, None


def _jax_schedule(plan, n_app, n_close, n_hold, n_lift):
    path, qs_d, qs_l = plan
    app = np.concatenate([jarm.resample_traj(path, n_app - 30),
                          jarm.resample_traj(qs_d, 30)])
    return np.concatenate([app, np.repeat(app[-1][None], n_close + n_hold, axis=0),
                           jarm.resample_traj(qs_l, n_lift)]).astype(np.float32)


def test_pick_and_place_slice_matches_jax(pile):
    """From one JAX-settled pile and the same candidates: the oracle NUNOCS
    pose within 1e-6; P(T|G) within 1e-6, P(G) and engagement within 1e-5;
    the threshold mask, the order and the chosen pick equal;
    the obstacle cloud equal; the RRT path, the descent and lift plans and
    the resampled schedule within 1e-4 rad."""
    _check_pick_and_place_slice(pile)


def test_pick_and_place_slice_matches_jax_for_class(class_pile):
    """The same checks on a screw pile and an hnm pile."""
    _check_pick_and_place_slice(class_pile)


def _check_pick_and_place_slice(pile):
    sc, can, meshes, lib, state, params, env, out = pile
    rng_j, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    target, m, pts, nrm, bg_m, nocs_j, grasps_cam = _jax_candidates(
        sc, can, meshes, state, params, out, rng_j)
    rng_p.choice(len(pts), min(len(pts), rgs.MAX_COLLISION_PTS), replace=False)
    nocs_p = rgs.oracle_nocs_pose(sc, port_state(state), port_params(params), target)
    np.testing.assert_allclose(nocs_p, nocs_j, atol=1e-6)
    assert len(grasps_cam) >= 16, "the sampler kept too few candidates"
    if len(grasps_cam) > rgs.MAX_CANDIDATES:
        sel = rng_j.choice(len(grasps_cam), rgs.MAX_CANDIDATES, replace=False)
        assert (rng_p.choice(len(grasps_cam), rgs.MAX_CANDIDATES, replace=False) == sel).all()
        grasps_cam = grasps_cam[sel]

    p_T_given_G, p_G, eng, ok, order = _jax_scores(can, nocs_j, pts, nrm, grasps_cam)
    found = rgs.Found(mask=m, target=target, pts=pts, nrm=nrm, bg_m=bg_m, nocs_pose=nocs_j,
                      grasps_cam=grasps_cam, prov=np.ones(len(grasps_cam), np.int32))
    sc_p = rgs.score_candidates(sc, load_config("config_run.yml"), found)
    np.testing.assert_allclose(sc_p.p_T_given_G, p_T_given_G, atol=1e-6)
    np.testing.assert_allclose(sc_p.p_G, p_G, atol=1e-5)
    # engagement divides a grasp-frame depth by the 45 mm finger: camera-frame
    # points ~0.7 m away carry 6e-8 m ulps, which two f32 transform orders
    # turn into up to ~2e-6 of engagement (1e-6 near the origin, in
    # test_torch_pickplace.py)
    np.testing.assert_allclose(sc_p.eng, eng, atol=1e-5)
    np.testing.assert_array_equal(sc_p.ok, ok)
    assert ok.sum() >= 2 and sc_p.order == order

    # obstacles: the visible non-target points, subsampled, and the fixture
    obs_cam = out["xyz"][bg_m]
    if len(obs_cam) > 1024:
        obs_cam = obs_cam[rng_j.choice(len(obs_cam), 1024, replace=False)]
    cib = t2n(sc.cam_in_base)
    obs_j = np.concatenate([obs_cam @ cib[:3, :3].T + cib[:3, 3], sc.fix_pts_base])
    obs_p = rgs.obstacles_in_base(sc, out["xyz"], bg_m, rng_p)
    np.testing.assert_array_equal(obs_p, obs_j.astype(np.float32))

    pick_j, plan_j = _jax_plan(sc, grasps_cam, order, obs_j, seed=0)
    pick_p, plan_p, _, _ = rgs.plan_pick(sc, grasps_cam, sc_p.order, obs_p, seed=0)
    assert pick_j is not None and pick_p == pick_j
    for a, b in zip(plan_p, plan_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4)
    sched_j = _jax_schedule(plan_j, rgs.N_APP, rgs.CLOSE_STEPS, rgs.LIFT_STEPS, rgs.N_LIFT_A)
    np.testing.assert_allclose(rgs.pick_schedule(plan_p), sched_j, atol=1e-4)


def test_short_arm_pick_matches_jax(pile):
    """One arm-executed pick on the JAX-settled pile along the same plan
    (the first candidate the pick gate takes), resampled to a short
    schedule (40 approach, 30 close, 20 hold, 10 lift steps): picked equal
    (and true),
    the object in the grasp frame within 1 mm, the width within 0.2 mm."""
    _check_short_arm_pick(pile, must_hold=True)


def test_short_arm_pick_matches_jax_for_class(class_pile):
    """The same short pick on a screw pile and an hnm pile: picked equal, the
    object in the grasp frame within 1 mm, the width within 0.2 mm."""
    _check_short_arm_pick(class_pile, must_hold=False)


def _check_short_arm_pick(pile, must_hold):
    sc, can, meshes, lib, state, params, env, out = pile
    rng = np.random.default_rng(0)
    target, m, pts, nrm, bg_m, nocs, grasps_cam = _jax_candidates(
        sc, can, meshes, state, params, out, rng)
    if len(grasps_cam) > rgs.MAX_CANDIDATES:
        grasps_cam = grasps_cam[rng.choice(len(grasps_cam), rgs.MAX_CANDIDATES, replace=False)]
    order = _jax_scores(can, nocs, pts, nrm, grasps_cam)[4]
    obs_cam = out["xyz"][bg_m]
    cib = t2n(sc.cam_in_base)
    obs = np.concatenate([obs_cam @ cib[:3, :3].T + cib[:3, 3], sc.fix_pts_base])
    _, plan = _jax_plan(sc, grasps_cam, order, obs, seed=0)
    kw = dict(n_app=40, n_close=30, n_hold=20)
    sched = _jax_schedule(plan, kw["n_app"], kw["n_close"], kw["n_hold"], 10)
    g = JGripper.default()
    rj = jarm.execute_pick_arm(lib, state, params, env, jnp.int32(target), jnp.asarray(sched),
                               jnp.asarray(sc.base_in_world), jnp.asarray(g.ee_in_grasp),
                               g.spec, narrowphase=sc.geometry, **kw)
    rp = rgs.simarm.execute_pick_arm(
        sc.lib, port_state(state), port_params(params), sc.env_bin, target,
        torch.as_tensor(sched), torch.as_tensor(sc.base_in_world),
        torch.as_tensor(sc.gripper.ee_in_grasp), sc.gripper.spec, narrowphase=sc.geometry, **kw)
    assert bool(rj[0]) or not must_hold, "the JAX pick should hold the nut"
    assert bool(rp[0]) == bool(rj[0])
    np.testing.assert_allclose(t2n(rp[2])[:3, 3], np.asarray(rj[2])[:3, 3], atol=1e-3)
    assert abs(float(rp[3]) - float(rj[3])) <= 2e-4


def test_one_round_smoke(tmp_path, monkeypatch):
    """The port's ``simulate_grasp_rounds`` alone, on the CPU: one round of
    2 nuts and one attempt, a 192x256 render, a small cone sampler, 64
    codebook grasps, and short settle and arm schedules.  The tallies are
    consistent (task <= stable <= attempts <= 1, objects <= 2) and the
    event log holds the loop's events, the tally last."""
    import json
    for name, v in (("SETTLE_STEPS", 120), ("RESETTLE_STEPS", 10), ("N_APP", 40),
                    ("CLOSE_STEPS", 20), ("LIFT_STEPS", 10), ("N_LIFT_A", 10),
                    ("N_MOVE_P", 50), ("N_DROP_P", 10)):
        monkeypatch.setattr(rgs, name, v)
    cfg = dict(load_config("config_run.yml"), cone_grasp_smapler_n_sphere_dir=2,
               cone_grasp_smapler_approach_step=0.02, nocs_grasp_sampler_max_n_grasp=64)
    path = tmp_path / "eval.jsonl"
    timings = {}
    c = rgs.simulate_grasp_rounds("nut", n_rounds=1, n_objects=2, cfg_run=cfg,
                                  canonical=dict(np.load(CANONICAL.format("nut"))), seed=0,
                                  max_attempts_per_round=1, render_hw=(192, 256),
                                  metrics_path=str(path), device="cpu", timings=timings)
    assert c.num_task_grasp_succ <= c.num_stable_grasp <= c.num_attempts <= 1
    assert 1 <= c.num_objects <= 2
    events = [json.loads(s) for s in path.read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "filter" and kinds[-2:] == ["tally", "summary"]
    assert ("attempt" in kinds) == (c.num_attempts == 1)
    tally = events[-2]
    assert [tally[k] for k in ("num_objects", "num_attempts", "num_stable_grasp",
                               "num_task_grasp_succ")] == \
        [c.num_objects, c.num_attempts, c.num_stable_grasp, c.num_task_grasp_succ]
    assert timings["settle_s"] > 0 and timings["render_s"] > 0 and timings["nocs_filter_s"] > 0


@pytest.mark.parametrize("mode", [pytest.param(dict(oracle=False), id="mode0"),
                                  pytest.param(dict(predicters={"grasp": None}), id="mode1"),
                                  pytest.param(dict(arm_dynamics=True), id="mode3")])
def test_modes_not_ported_raise(mode, monkeypatch):
    """Every mode is ported, so none raises for being unported.  Learned
    mode without a NUNOCS predicter is refused with a ``ValueError`` before
    any work; a grasp predicter in oracle mode and arm dynamics pass the
    mode check to the scene set-up."""
    def set_up(*a, **k):
        raise LookupError("set-up reached")

    monkeypatch.setattr(rgs, "setup_scene", set_up)
    if "oracle" in mode:
        with pytest.raises(ValueError, match="NUNOCS predicter"):
            rgs.simulate_grasp_rounds("nut", n_rounds=1, device="cpu", verbose=False, **mode)
        with pytest.raises(LookupError, match="set-up reached"):
            rgs.main(["--oracle", "0", "--artifacts", "artifacts_tracked/nut", "--device", "cpu"])
    else:
        with pytest.raises(LookupError, match="set-up reached"):
            rgs.simulate_grasp_rounds("nut", n_rounds=1, device="cpu", verbose=False, **mode)
