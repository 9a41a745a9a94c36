"""Port parity for the modules of the pick-and-place half of the eval:
symmetries and the NUNOCS frame, IK and planning, the gripper's closing law
and colliders, the arm executors, the placement check, grasp quality,
engagement depth, the NOCS-transfer sampler and the metrics log.

The same numpy inputs, made from a seed, go through the JAX function and
its port; each test states its tolerance.  JAX's collision gate runs its
plain ("xla") path, the port's its plain PyTorch version (CPU tensors).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import symmetry as jsym
from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.grasp import filter as jfilter
from catgrasp_tpu.grasp import quality as jquality
from catgrasp_tpu.grasp import sampler as jsampler
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.kin import iiwa as jiiwa
from catgrasp_tpu.kin import planner as jplanner
from catgrasp_tpu.pipelines import make_canonical as jcanon
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_grasp as jgrasp
from catgrasp_tpu.sim import env_semantic as jsem
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu.utils import metrics as jmetrics
from catgrasp_tpu_torch.core import symmetry as psym
from catgrasp_tpu_torch.grasp import filter as pfilter
from catgrasp_tpu_torch.grasp import quality as pquality
from catgrasp_tpu_torch.grasp import sampler as psampler
from catgrasp_tpu_torch.grasp.gripper import Gripper as PGripper
from catgrasp_tpu_torch.kin import iiwa as piiwa
from catgrasp_tpu_torch.kin import planner as pplanner
from catgrasp_tpu_torch.pipelines import make_canonical as pcanon
from catgrasp_tpu_torch.sim import arm as parm
from catgrasp_tpu_torch.sim import env_grasp as pgrasp
from catgrasp_tpu_torch.sim import env_semantic as psem
from catgrasp_tpu_torch.utils import metrics as pmetrics
from test_torch_common import np_fields, port_env, port_lib, port_params, port_state, t2n

torch.set_num_threads(2)
SPEC_J, SPEC_P = jgrasp.GripperSpec(), pgrasp.GripperSpec()
BASE = np.eye(4, dtype=np.float32)
BASE[:3, 3] = [-0.559, -0.367, 0.052]


def T(x):
    return torch.as_tensor(np.asarray(x))


# --- symmetries, NUNOCS frame, metrics log ---------------------------------


@pytest.mark.parametrize("cls", ["nut", "screw", "hnm"])
def test_symmetry_tfs_equal(cls):
    """Exactly equal tables (12, 72 and 2 transforms)."""
    j, p = jsym.get_symmetry_tfs(cls), psym.get_symmetry_tfs(cls)
    assert p.dtype == np.float32 and p.shape == j.shape
    np.testing.assert_array_equal(p, j)


def test_to_nunocs_transform_equal():
    """Exactly equal on mesh vertices at three scales and on random clouds."""
    rng = np.random.default_rng(0)
    clouds = [jprim.make_instance("nut", "test", 0).vertices * s for s in (0.9, 1.0, 1.1)]
    clouds += [rng.normal(size=(100, 3)) * rng.uniform(0.01, 0.1, 3) for _ in range(3)]
    for pts in clouds:
        np.testing.assert_array_equal(pcanon.to_nunocs_transform(pts),
                                      jcanon.to_nunocs_transform(pts))


def test_metrics_log_writes_the_same_records(tmp_path):
    """The same events give the same JSONL records but for the wall-clock
    stamp ``t``; tensors and arrays become JSON as numpy values do."""
    recs = []
    for mod, name, conv in ((jmetrics, "j.jsonl", np.asarray), (pmetrics, "p.jsonl", T)):
        log = mod.MetricsLogger(str(tmp_path / name), run="eval", seed=0)
        log.event("filter", round=0, n_valid=np.int64(3), stats=conv(np.arange(3)))
        log.event("attempt", picked=True, p_G=np.float32(0.5), w=conv(np.float32(0.25)))
        log.close()
        lines = [json.loads(s) for s in (tmp_path / name).read_text().splitlines()]
        recs.append([{k: v for k, v in r.items() if k != "t"} for r in lines])
    assert recs[0] == recs[1] and len(recs[0]) == 3


# --- IK and planning --------------------------------------------------------


def _fk_poses(rng, n):
    """Flange poses of configs clear of the joint limits and of the
    shoulder, elbow and wrist singularities."""
    lim = np.float32(jiiwa.JOINT_LIMITS)
    q = rng.uniform(-0.8, 0.8, (n, 7)).astype(np.float32) * lim
    for j in (1, 3, 5):
        q[:, j] = np.sign(q[:, j] + 1e-9) * rng.uniform(0.3, 1.6, n)
    return np.asarray(jax.vmap(jiiwa.fk)(jnp.asarray(q)))


@pytest.fixture(scope="module")
def ik_cases():
    rng = np.random.default_rng(1)
    Ts = _fk_poses(rng, 96)
    far = Ts[:4].copy()
    far[:, :3, 3] = [[2.0, 0.0, 0.5], [0.0, -2.0, 0.0], [0.1, 0.1, 2.0], [0.0, 0.0, 0.36]]
    Ts = np.concatenate([Ts, far])
    qj, vj = (np.asarray(x) for x in jax.vmap(jiiwa.ik)(jnp.asarray(Ts)))
    # keep poses whose every candidate is clear of the joint limits by 1e-4
    lim = np.float32(jiiwa.JOINT_LIMITS)
    clear = np.all(np.abs(np.abs(qj) - lim) > 1e-4, axis=(1, 2))
    return Ts[clear], qj[clear], vj[clear]


def test_ik_matches_jax(ik_cases):
    """``ik`` and ``ik_batch``: the valid masks equal on every candidate of
    every pose (some unreachable); q within 1e-4 rad on the valid
    candidates clear of the wrist and shoulder singularities (|sin q2|,
    |sin q6|, |q4| > 0.05), where an ulp of the 3x3 products turns the
    spin split by up to 2e-4."""
    Ts, qj, vj = ik_cases
    assert len(Ts) >= 80 and (~vj.any(axis=1)).sum() >= 3 and vj.mean() > 0.3
    qp, vp = (t2n(x) for x in piiwa.ik_batch(T(Ts)))
    np.testing.assert_array_equal(vp, vj)
    q1, v1 = (t2n(x) for x in piiwa.ik(T(Ts[0])))
    np.testing.assert_array_equal(q1, qp[0])
    np.testing.assert_array_equal(v1, vp[0])
    regular = ((np.abs(np.sin(qj[..., 1])) > 0.05) & (np.abs(np.sin(qj[..., 5])) > 0.05)
               & (np.abs(qj[..., 3]) > 0.05))
    sel = vj & regular
    assert sel.sum() > 0.8 * vj.sum()
    np.testing.assert_allclose(qp[sel], qj[sel], atol=1e-4)


def test_ik_best_matches_jax(ik_cases):
    """``ik_best`` with and without a reference config: found equal, q
    within 1e-4 rad."""
    Ts, _, _ = ik_cases
    ref = np.array([0.3, 0.5, 0.1, -1.0, 0.2, 0.8, 0.0], np.float32)
    for q_ref in (None, ref):
        qp, fp = (t2n(x) for x in piiwa.ik_best(T(Ts), None if q_ref is None else T(q_ref)))
        for k, Tk in enumerate(Ts):
            qj, fj = jiiwa.ik_best(jnp.asarray(Tk), None if q_ref is None else jnp.asarray(q_ref))
            assert bool(fj) == bool(fp[k])
            np.testing.assert_allclose(qp[k], np.asarray(qj), atol=1e-4)


def test_arm_capsules_and_collisions_match_jax():
    """Capsule points within 1e-6 m; ``configs_collide`` equal on 64
    configs against a cloud whose points clear every capsule radius (and
    the floor band) by >= 1e-4 m."""
    rng = np.random.default_rng(2)
    qs = (rng.uniform(-0.9, 0.9, (64, 7)) * jiiwa.JOINT_LIMITS).astype(np.float32)
    pj, rj = (np.asarray(x) for x in jplanner.arm_capsule_points(jnp.asarray(qs)))
    pp, rp = (t2n(x) for x in pplanner.arm_capsule_points(T(qs)))
    np.testing.assert_allclose(pp, pj, atol=1e-6)
    np.testing.assert_array_equal(rp, rj)
    cloud = rng.uniform(-0.8, 0.8, (200, 3)).astype(np.float32)
    cloud[:, 2] = np.abs(cloud[:, 2]) + 0.1
    d = np.sqrt(((pj[:, :, None] - cloud[None, None]) ** 2).sum(-1))  # (B, L, C)
    keep = np.all(np.abs(d - rj[None, :, None]) > 1e-4, axis=(0, 1))
    cloud = cloud[keep]
    floor_z = -0.3
    band = np.abs(pj[..., 2] - (floor_z + rj * 0.5))
    qs, pj = qs[band.min(axis=1) > 1e-4], pj[band.min(axis=1) > 1e-4]
    mask = rng.uniform(size=len(cloud)) > 0.1
    hj = np.asarray(jplanner.configs_collide(jnp.asarray(qs), jnp.asarray(cloud),
                                             jnp.asarray(mask), floor_z))
    hp = t2n(pplanner.configs_collide(T(qs), T(cloud), T(mask), floor_z))
    assert 0 < hj.sum() < len(hj)
    np.testing.assert_array_equal(hp, hj)


@pytest.mark.parametrize("obstacle", [False, True])
def test_rrt_plans_the_same_path(obstacle):
    """With the same seed and the same collision answers the port draws the
    same samples: the same waypoint list within 1e-5 rad, in free space and
    around a blob between start and goal (whose points clear every radius
    checked by the run, or the answers, and the trees, could differ)."""
    q0 = np.array([0.0, 0.4, 0.0, -1.2, 0.0, 0.6, 0.0], np.float32)
    q1 = np.array([1.4, 0.8, 0.3, -0.9, 0.2, 0.9, 0.5], np.float32)
    if obstacle:
        qm = (q0 + q1) / 2
        T_E = np.asarray(jiiwa.fk_frames(jnp.asarray(qm))[1])
        obs = (T_E[:3, 3] + np.random.default_rng(4).normal(scale=0.03, size=(64, 3)))
    else:
        obs = np.array([[5.0, 5.0, 5.0]])
    obs = obs.astype(np.float32)
    kw = dict(step=0.3, n_check=6, seed=11, floor_z=-0.3)
    pj = jplanner.RRTConnect(obs, **kw).plan(q0, q1, max_iter=300)
    pp = pplanner.RRTConnect(obs, device="cpu", **kw).plan(q0, q1, max_iter=300)
    assert pj is not None and pp is not None
    if obstacle:
        assert len(pj) > 2, "the direct edge should be blocked"
    assert len(pp) == len(pj)
    np.testing.assert_allclose(np.stack(pp), np.stack(pj), atol=1e-5)


def test_plan_cartesian_waypoints_matches_jax():
    """``ok`` equal, ``qs`` within 1e-4 rad: a vertical retreat, a descent
    toward the bin, and a path leaving the workspace (no IK: not ok)."""
    q0 = np.array([0.3, 0.5, 0.1, -1.0, 0.2, 0.8, 0.0], np.float32)
    T0 = np.asarray(jiiwa.fk(jnp.asarray(q0)))
    up = np.stack([T0] * 5)
    up[:, 2, 3] += np.linspace(0, 0.05, 5)
    side = np.stack([T0] * 5)
    side[:, 0, 3] += np.linspace(0, 0.1, 5)
    out = np.stack([T0] * 5)
    out[:, 0, 3] += np.linspace(0, 1.5, 5)
    for poses, seed, want in ((up, q0, True), (side, None, True), (out, q0, False)):
        qj, okj = jplanner.plan_cartesian_waypoints(poses, q_seed=seed)
        qp, okp = pplanner.plan_cartesian_waypoints(poses, q_seed=seed, device="cpu")
        assert okj == okp == want
        if want:
            np.testing.assert_allclose(qp, qj, atol=1e-4)


# --- the gripper -------------------------------------------------------------


def _closing_clouds(n_ticks):
    """An off-centre nut in the grasp frame (4 mm toward +y), recoiling
    0.05 mm a tick toward -y once the +y finger has had time to land: the
    free, wall and squeeze regimes all occur."""
    pts = np.asarray(jprim.make_instance("nut", "test", 0).sample_surface(
        400, np.random.default_rng(0)), np.float32)
    pts = pts[:, [2, 0, 1]] + np.float32([0.02, 0.004, 0.0])
    return [pts - np.float32([0, 5e-5 * max(i - 30, 0), 0]) for i in range(n_ticks)]


def test_closing_step_matches_jax():
    """60 ticks of the closing law (closing for 40, then holding): width
    and centre within 1e-6 m and the latch equal at every tick; the ticks
    pass through the free, lone-wall and squeeze regimes."""
    step_j = jax.jit(jgrasp.closing_step, static_argnames=("closing", "spec", "dt"))
    dt = jengine.DT
    wj, cj, tj = jnp.float32(SPEC_J.max_width), jnp.float32(0.0), jgrasp.closing_touched_init()
    wp, cp, tp = torch.tensor(SPEC_P.max_width), torch.tensor(0.0), pgrasp.closing_touched_init()
    latches = set()
    for i, pts in enumerate(_closing_clouds(60)):
        closing = i < 40
        wj, cj, tj, vpj, vnj = step_j(jnp.asarray(pts), wj, cj, tj, closing, SPEC_J, dt)
        wp, cp, tp, vpp, vnp = pgrasp.closing_step(T(pts), wp, cp, tp, closing, SPEC_P, dt)
        np.testing.assert_array_equal(t2n(tp), np.asarray(tj), err_msg=f"tick {i}")
        np.testing.assert_allclose(float(wp), float(wj), atol=1e-6, err_msg=f"tick {i}")
        np.testing.assert_allclose(float(cp), float(cj), atol=1e-6, err_msg=f"tick {i}")
        np.testing.assert_allclose([float(vpp), float(vnp)], [float(vpj), float(vnj)],
                                   atol=1e-6 / dt)
        latches.add(tuple(np.asarray(tj).tolist()))
    assert {(False, False), (True, False), (True, True)} <= latches or \
        {(False, False), (False, True), (True, True)} <= latches


def test_gripper_env_and_contacts_match_jax():
    """``gripper_env`` fields within 1e-6; ``finger_contact_points`` and
    ``open_gripper_collision`` equal, on random grasp poses, widths, centres
    and clouds."""
    rng = np.random.default_rng(5)
    from test_torch_common import random_poses
    Ts = random_poses(rng, 6)
    for k, Tg in enumerate(Ts):
        w, c, vp_, vn_ = (np.float32(x) for x in rng.uniform([0.005, -0.003, -0.1, -0.1],
                                                             [0.05, 0.003, 0.3, 0.3]))
        grip = bool(k % 2)
        ej = jgrasp.gripper_env(jnp.asarray(Tg), jnp.asarray(w), jnp.asarray(c),
                                jnp.asarray(vp_), jnp.asarray(vn_), SPEC_J, grip=grip)
        ep = pgrasp.gripper_env(T(Tg), T(w), T(c), T(vp_), T(vn_), SPEC_P, grip=grip)
        for name, vj in np_fields(ej).items():
            vp = t2n(getattr(ep, name))
            if vj.dtype == bool:
                np.testing.assert_array_equal(vp, vj, err_msg=name)
            else:
                np.testing.assert_allclose(vp, vj, atol=1e-6, err_msg=name)
        pts = rng.uniform(-0.04, 0.06, (500, 3)).astype(np.float32)
        for tol in (0.002, 0.004):
            mj = jgrasp.finger_contact_points(jnp.asarray(pts), jnp.asarray(w), SPEC_J,
                                              surface_tol=tol, center=jnp.asarray(c))
            mp = pgrasp.finger_contact_points(T(pts), T(w), SPEC_P, surface_tol=tol,
                                              center=T(c))
            for a, b in zip(mp, mj):
                np.testing.assert_array_equal(t2n(a), np.asarray(b))
        for cloud in (pts, pts * 0.1 + np.float32([0.1, 0.0, 0.0])):
            assert bool(pgrasp.open_gripper_collision(T(cloud), SPEC_P)) == \
                bool(jgrasp.open_gripper_collision(jnp.asarray(cloud), SPEC_J))


# --- the arm ------------------------------------------------------------------


def test_arm_boxes_env_and_grasp_pose_match_jax():
    """``arm_link_boxes`` (one config and a batch), ``arm_env`` and
    ``grasp_pose_of`` within 1e-5; ``resample_traj`` equal."""
    rng = np.random.default_rng(6)
    g = JGripper.default()
    qs = (rng.uniform(-0.8, 0.8, (5, 7)) * jiiwa.JOINT_LIMITS).astype(np.float32)
    cb, hb, qb = (t2n(x) for x in parm.arm_link_boxes(T(qs), T(BASE)))
    for k, q in enumerate(qs):
        for a, b, batched in zip(parm.arm_link_boxes(T(q), T(BASE)),
                                 jarm.arm_link_boxes(jnp.asarray(q), jnp.asarray(BASE)),
                                 (cb, hb, qb)):
            np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-5)
            np.testing.assert_allclose(batched[k], np.asarray(b), atol=1e-5)
        ej = jarm.arm_env(jnp.asarray(q), jnp.asarray(qs[k - 1]), jnp.asarray(BASE), 1 / 240)
        ep = parm.arm_env(T(q), T(qs[k - 1]), T(BASE), 1 / 240)
        for name, vj in np_fields(ej).items():
            np.testing.assert_allclose(t2n(getattr(ep, name)).astype(np.float32), vj,
                                       atol=1e-5 / (1 / 240) if name == "vel" else 1e-5)
        np.testing.assert_allclose(
            t2n(parm.grasp_pose_of(T(q), T(BASE), T(g.ee_in_grasp))),
            np.asarray(jarm.grasp_pose_of(jnp.asarray(q), jnp.asarray(BASE),
                                          jnp.asarray(g.ee_in_grasp))), atol=1e-5)
    for way in (qs[:1], qs[:2], qs):
        np.testing.assert_array_equal(parm.resample_traj(way, 17), jarm.resample_traj(way, 17))


def _tiny_world():
    """``tests/test_arm.py``'s world: one nut (32 surface points) resting at
    6 mm in an open bin."""
    lib = jbuild([jprim.make_instance("nut", "train", 0)],
                 [jcsg.make_csg_instance("nut", "train", 0)], n_surf=32)
    params = JSceneParams.create(lib, jnp.array([0], jnp.int32), jnp.array([1.0]))
    state = JSceneState.create(1).replace(active=jnp.array([True]),
                                          pos=jnp.array([[0.0, 0.0, 0.006]]))
    env = jengine.StaticEnv.open_bin((0.3, 0.3, 0.12))
    return (lib, params, state, env), (port_lib(lib), port_params(params), port_state(state),
                                       port_env(env))


@pytest.fixture(scope="module")
def world():
    return _tiny_world()


def _q_over_nut(depth):
    """A config whose grasp frame is top-down over the nut's center, the
    finger roots at height ``depth`` (the fingertips 45 mm lower)."""
    g = JGripper.default()
    G = np.eye(4, dtype=np.float32)
    G[:3, :3] = np.array([[0, 0, -1], [1, 0, 0], [0, -1, 0]], np.float32).T  # columns
    G[:3, 3] = [0.0, 0.0, depth]
    ee = np.linalg.inv(BASE) @ G @ g.ee_in_grasp
    q, ok = jiiwa.ik_best(jnp.asarray(ee.astype(np.float32)))
    assert bool(ok)
    return np.asarray(q)


def _states_close(sp, sj, atol):
    for name in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(t2n(getattr(sp, name)), np.asarray(getattr(sj, name)),
                                   atol=atol, err_msg=name)


def test_executors_step_for_step(world):
    """Three steps of each executor around the nut (approach, close, lift;
    move, release, drop): the state within 1e-5 m (and 1e-5 in quaternion
    and velocities), width, centre and the gate quantities alike."""
    (lj, parj, sj, ej), (lp, parp, sp, ep) = world
    g = JGripper.default()
    q = _q_over_nut(0.046)  # the fingertips 1 mm above the floor
    sched = np.stack([q, q, q]).astype(np.float32)
    kw = dict(n_app=1, n_close=1, n_hold=0)
    rj = jarm.execute_pick_arm(lj, sj, parj, ej, jnp.int32(0), jnp.asarray(sched),
                               jnp.asarray(BASE), jnp.asarray(g.ee_in_grasp), SPEC_J, **kw)
    rp = parm.execute_pick_arm(lp, sp, parp, ep, 0, T(sched), T(BASE), T(g.ee_in_grasp),
                               SPEC_P, **kw)
    _states_close(rp[1], rj[1], 1e-5)
    assert bool(rp[0]) == bool(rj[0])
    for a, b in zip(rp[2:], rj[2:]):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-5)
    oig = np.eye(4, dtype=np.float32)
    oig[:3, 3] = [0.03, 0.001, 0.0]
    kw = dict(n_move=2, n_drop=1)
    fj, obj, trj = jarm.execute_place_arm(lj, sj, parj, ej, jnp.int32(0), jnp.asarray(sched),
                                          jnp.asarray(BASE), jnp.asarray(g.ee_in_grasp),
                                          jnp.asarray(oig), jnp.float32(0.014), SPEC_J, **kw)
    fp, obp, trp = parm.execute_place_arm(lp, sp, parp, ep, 0, T(sched), T(BASE),
                                          T(g.ee_in_grasp), T(oig), T(np.float32(0.014)),
                                          SPEC_P, **kw)
    _states_close(fp, fj, 1e-5)
    np.testing.assert_allclose(t2n(obp), np.asarray(obj), atol=1e-5)
    for a, b in zip(trp, trj):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-5)


def test_executors_short_schedules_match_jax(world):
    """The short schedules of ``tests/test_arm.py``: the arm far from the
    nut (picked False in both), a transport with a one-step release and an
    off-centre squeezed release: the dropped object's xy within 4 mm."""
    (lj, parj, sj, ej), (lp, parp, sp, ep) = world
    g = JGripper.default()
    q0 = np.zeros(7, np.float32)
    q0[1], q0[3] = 0.6, -1.2
    sched = np.repeat(q0[None], 4 + 6 + 6 + 4, axis=0)
    kw = dict(n_app=4, n_close=6, n_hold=6)
    pj = jarm.execute_pick_arm(lj, sj, parj, ej, jnp.int32(0), jnp.asarray(sched),
                               jnp.asarray(BASE), jnp.asarray(g.ee_in_grasp), SPEC_J, **kw)[0]
    pp = parm.execute_pick_arm(lp, sp, parp, ep, 0, T(sched), T(BASE), T(g.ee_in_grasp),
                               SPEC_P, **kw)[0]
    assert bool(pp) == bool(pj) is False
    qa = np.zeros(7, np.float32)
    qa[1], qa[3] = 0.35, -1.6
    qb = np.zeros(7, np.float32)
    qb[1], qb[3] = 0.55, -1.4
    move = jarm.resample_traj(np.stack([qa, qb]), 12)
    cases = [(np.concatenate([move, move[-1:]]), [0.02, 0.0, 0.0], g.spec.max_width, 12, 1),
             (np.repeat(qa[None], 18, axis=0), [0.02, 0.0015, 0.0], 0.014, 2, 16)]
    for sched, t, width, n_move, n_drop in cases:
        oig = np.eye(4, dtype=np.float32)
        oig[:3, 3] = t
        _, obj, _ = jarm.execute_place_arm(
            lj, sj, parj, ej, jnp.int32(0), jnp.asarray(sched), jnp.asarray(BASE),
            jnp.asarray(g.ee_in_grasp), jnp.asarray(oig), jnp.float32(width), SPEC_J,
            n_move=n_move, n_drop=n_drop)
        _, obp, _ = parm.execute_place_arm(
            lp, sp, parp, ep, 0, T(sched), T(BASE), T(g.ee_in_grasp), T(oig),
            T(np.float32(width)), SPEC_P, n_move=n_move, n_drop=n_drop)
        np.testing.assert_allclose(t2n(obp)[:2, 3], np.asarray(obj)[:2, 3], atol=4e-3)


@pytest.mark.parametrize("cls", ["nut", "screw", "hnm"])
def test_place_success_band_edges(cls):
    """Equal on a grid of poses either side of each band edge (xy radius,
    z max and min, the tilt limit of screw and hnm)."""
    place = jsem.TASK_POSES[cls][1].astype(np.float32)
    xy, zmax, zmin = jsem._SUCCESS_XY[cls], jsem._SUCCESS_Z_MAX[cls], jsem._SUCCESS_Z_MIN[cls]
    poses = []
    for r in (0.0, xy - 1e-5, xy + 1e-5):
        for z in (zmin - 1e-5, zmin + 1e-5, (zmin + zmax) / 2, zmax - 1e-5, zmax + 1e-5):
            for tilt in (0.0, np.deg2rad(80.0) - 1e-3, np.deg2rad(80.0) + 1e-3, np.pi):
                P = np.eye(4, dtype=np.float32)
                c, s = np.cos(tilt), np.sin(tilt)
                P[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
                P[:3, 3] = [place[0] + r * 0.6, place[1] + r * 0.8, z]
                poses.append(P)
    poses = np.stack(poses)
    want = np.array([bool(jsem.place_success(cls, jnp.asarray(P), jnp.asarray(place)))
                     for P in poses])
    got = t2n(psem.place_success(cls, T(poses), T(place)))
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)


# --- scoring -------------------------------------------------------------------


def test_quality_direction_table_is_jax_draw():
    """The port's direction table is exactly the installed JAX's
    ``jax.random.normal(PRNGKey(0), (512, 6))``, before normalisation, and
    its first 256 rows are the (256, 6) draw ``parallel_jaw_quality``
    takes."""
    table = np.load(pquality.DIRS_FILE)
    assert table.dtype == np.float32
    np.testing.assert_array_equal(
        table, np.asarray(jax.random.normal(jax.random.PRNGKey(0), (512, 6))))
    np.testing.assert_array_equal(
        table[:256], np.asarray(jax.random.normal(jax.random.PRNGKey(0), (256, 6))))


@pytest.fixture(scope="module")
def nut_grasps():
    """A nut's surface cloud with normals and 64 grasps around it: random
    approach directions at the cloud's centroid, backed off so that the
    fingers straddle the part, with depth and lateral offsets."""
    rng = np.random.default_rng(7)
    mesh = jprim.make_instance("nut", "test", 0)
    pts = np.asarray(mesh.sample_surface(700, rng), np.float32)
    nrm = pts - pts.mean(0)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    from test_torch_common import random_poses
    G = random_poses(rng, 64, spread=0.0)
    G[:, :3, 3] = (pts.mean(0) - G[:, :3, 0] * rng.uniform(0.005, 0.03, (64, 1))
                   + G[:, :3, 1] * rng.uniform(-0.004, 0.004, (64, 1)))
    return pts, nrm, G.astype(np.float32)


def test_parallel_jaw_quality_matches_jax(nut_grasps):
    """Within 1e-5 on 64 grasps, most of them with contacts on both
    fingers."""
    pts, nrm, G = nut_grasps
    qj = np.asarray(jquality.parallel_jaw_quality(jnp.asarray(pts), jnp.asarray(nrm),
                                                  jnp.asarray(G), SPEC_J))
    qp = t2n(pquality.parallel_jaw_quality(T(pts), T(nrm), T(G), SPEC_P))
    assert (qj > 0).sum() >= 16
    np.testing.assert_allclose(qp, qj, atol=1e-5)


def test_engagement_depth_matches_jax(nut_grasps):
    """Within 1e-6 on 64 grasps, and zeros for a 2-point cloud."""
    pts, _, G = nut_grasps
    ej = np.asarray(jfilter.engagement_depth(jnp.asarray(pts), jnp.asarray(G), SPEC_J))
    ep = t2n(pfilter.engagement_depth(T(pts), T(G), SPEC_P))
    assert (ej > 0).sum() >= 16
    np.testing.assert_allclose(ep, ej, atol=1e-6)
    np.testing.assert_array_equal(t2n(pfilter.engagement_depth(T(pts[:2]), T(G), SPEC_P)), 0)


def test_grasp_affordance_matches_jax_loop(nut_grasps):
    """The batched P(T|G) within 1e-6 of the JAX per-grasp loop, from the
    repo's nut canonical under a scaled, rotated NUNOCS pose."""
    from catgrasp_tpu.pipelines import run_grasp_simulation as jrgs
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as prgs
    can = dict(np.load("dataset/nut_canonical.npz"))
    pts, _, G = nut_grasps
    nocs_pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    nocs_pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) \
        @ np.diag([0.024, 0.024, 0.008]).astype(np.float32)
    nocs_pose[:3, 3] = pts.mean(0)
    aj = jrgs.grasp_affordance(can, nocs_pose, G, width=0.012, spec=SPEC_J)
    ap = prgs.grasp_affordance(can, nocs_pose, G, width=0.012, spec=SPEC_P, device="cpu")
    assert (aj > 0).sum() >= 8
    np.testing.assert_allclose(ap, aj, atol=1e-6)


def test_nocs_sampler_matches_jax():
    """``NocsTransferGraspSampler.sample_grasps`` on a small codebook (64
    grasps of the nut canonical x its 12 symmetries) under a NUNOCS pose in
    view: the valid masks agree on >= 99.9% of candidates, the counters
    within 0.1%, kept poses within 1e-5; ``center_object_between_fingers``
    within 1e-6."""
    can = dict(np.load("dataset/nut_canonical.npz"))
    rng = np.random.default_rng(8)
    keep = np.flatnonzero(can["canonical_grasp_scores"] >= 0.95)
    idx = rng.choice(keep, 64, replace=False)
    grasps, scores = can["canonical_grasps"][idx], can["canonical_grasp_scores"][idx]
    nocs_pose = np.eye(4, dtype=np.float32)
    nocs_pose[:3, :3] = np.diag([0.024, -0.024, -0.008]).astype(np.float32)
    nocs_pose[:3, 3] = [0.0, 0.0, 0.69]
    pts_nocs = can["canonical_cloud"][rng.choice(1024, 512, replace=False)]
    target = (pts_nocs @ nocs_pose[:3, :3].T + nocs_pose[:3, 3]).astype(np.float32)
    # the bin floor under the part, as the occupancy fill makes it
    bg = rng.uniform([-0.1, -0.1, 0.7], [0.1, 0.1, 0.72], (4096, 3)).astype(np.float32)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam[:3, 3] = [0, 0, 0.7]
    cam_in_base = (np.linalg.inv(BASE) @ cam).astype(np.float32)
    sym = jsym.get_symmetry_tfs("nut")
    js = jsampler.NocsTransferGraspSampler(JGripper.default(), grasps, scores,
                                           score_larger_than=0.95)
    ps = psampler.NocsTransferGraspSampler(PGripper.default(), grasps, scores,
                                           score_larger_than=0.95)
    Tj, vj, sj = js.sample_grasps(jnp.asarray(nocs_pose), jnp.asarray(sym), bg,
                                  np.ones(len(bg), bool), target, np.ones(512, bool),
                                  cam_in_world=jnp.asarray(cam_in_base), filter_ik=True,
                                  chunk=128, adjust_depth=True, backend="xla")
    Tp, vp, sp = ps.sample_grasps(T(nocs_pose), sym, bg, np.ones(len(bg), bool), target,
                                  np.ones(512, bool), cam_in_world=cam_in_base,
                                  filter_ik=True, adjust_depth=True)
    vj, vp = np.asarray(vj), t2n(vp)
    assert len(vj) == 64 * 12 and 0 < vj.sum() < len(vj), {k: int(v) for k, v in sj.items()}
    assert (vj == vp).mean() >= 0.999
    for k, v in sj.items():
        assert abs(int(sp[k]) - int(v)) <= max(1e-3 * int(v), 0), (k, int(sp[k]), int(v))
    both = vj & vp
    np.testing.assert_allclose(t2n(Tp)[both], np.asarray(Tj)[both], atol=1e-5)
    cj = np.asarray(jsampler.center_object_between_fingers(jnp.asarray(np.asarray(Tj)[:50]),
                                                           jnp.asarray(target)))
    cp = t2n(psampler.center_object_between_fingers(Tp[:50], T(target)))
    np.testing.assert_allclose(cp, cj, atol=1e-6)
