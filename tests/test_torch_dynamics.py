"""Port parity for the articulated arm dynamics (``kin/dynamics.py``,
``sim/arm.py:dynamicize_schedule``) and the eval's ``--arm_dynamics 1``.

RNEA, the mass matrix, the bias forces and the forward dynamics are held to
JAX's at seeded configurations within 1e-5 of the largest magnitude;
``track_schedule`` over a 120-waypoint schedule within 1e-4 rad.  The
invariants of ``tests/test_dynamics.py`` (the chain equal to ``iiwa.fk``,
M(q) SPD, RNEA = M qdd + bias, energy, passivity, the PD hold, the torque
limit, tracking) are held on the port.  The eval's ``main`` with
``--arm_dynamics 1`` on short schedules hands ``execute_pick_arm`` (and
``execute_place_arm`` when it places) JAX's dynamicized schedule of the
same plan within 1e-4 rad.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.kin import dynamics as jdyn
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu_torch.kin import dynamics as dyn
from catgrasp_tpu_torch.kin import iiwa
from catgrasp_tpu_torch.sim import arm as simarm
from test_torch_common import t2n

torch.set_num_threads(2)
Q0 = np.deg2rad([10.0, 30.0, -20.0, -60.0, 15.0, 45.0, 5.0]).astype(np.float32)
RNG = np.random.default_rng(0)
QS = RNG.uniform(-1.5, 1.5, (6, 7)).astype(np.float32)
QDS = RNG.uniform(-1.0, 1.0, (6, 7)).astype(np.float32)
QDDS = RNG.uniform(-3.0, 3.0, (6, 7)).astype(np.float32)
TAUS = RNG.uniform(-30.0, 30.0, (6, 7)).astype(np.float32)

CASES = {
    "rnea": (jdyn.rnea, dyn.rnea, (QS, QDS, QDDS)),
    "mass_matrix": (jdyn.mass_matrix, dyn.mass_matrix, (QS,)),
    "bias_forces": (jdyn.bias_forces, dyn.bias_forces, (QS, QDS)),
    "forward_dynamics": (jdyn.forward_dynamics, dyn.forward_dynamics, (QS, QDS, TAUS)),
    "fk_flange": (jdyn.fk_flange, dyn.fk_flange, (QS,)),
    "kinetic_energy": (jdyn.kinetic_energy, dyn.kinetic_energy, (QS, QDS)),
    "potential_energy": (jdyn.potential_energy, dyn.potential_energy, (QS,)),
    "pd_torque": (jdyn.pd_torque, dyn.pd_torque, (QS, QDS, QDDS)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_at_seeded_states(name):
    """Each function at 6 seeded (q, qd, qdd, tau): JAX one state a call,
    the port all 6 at once over a leading axis; within 1e-5 of the largest
    magnitude."""
    jf, pf, args = CASES[name]
    j = np.stack([np.asarray(jf(*[jnp.asarray(a[i]) for a in args])) for i in range(len(QS))])
    p = t2n(pf(*[torch.as_tensor(a) for a in args]))
    assert p.shape == j.shape and p.dtype == np.float32
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * np.abs(j).max())


def _ramp(T=100, hold=20):
    goal = Q0 + np.deg2rad([20, -10, 15, 10, -20, 15, 30]).astype(np.float32)
    a = np.linspace(0.0, 1.0, T, dtype=np.float32)[:, None]
    return np.concatenate([Q0 * (1 - a) + goal * a, np.tile(goal, (hold, 1))]).astype(np.float32)


def test_track_schedule_matches_jax():
    """120 waypoints (a ramp and a hold) at the eval's 1/240 s: the achieved
    joints within 1e-4 rad of JAX's, the last substep's torques within 1e-3
    N m."""
    traj = _ramp()
    jq, jt = jdyn.track_schedule(jnp.asarray(Q0), jnp.asarray(traj), dt=1.0 / 240)
    pq, pt = dyn.track_schedule(torch.as_tensor(Q0), torch.as_tensor(traj), dt=1.0 / 240)
    assert pq.shape == (120, 7) and pt.shape == (120, 7)
    np.testing.assert_allclose(t2n(pq), np.asarray(jq), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t2n(pt), np.asarray(jt), rtol=0, atol=1e-3)


def test_dynamicize_schedule_matches_jax():
    path = np.stack([Q0, Q0 + 0.1])
    sched = simarm.resample_traj(path, 40)
    j = jarm.dynamicize_schedule(sched)
    p = t2n(simarm.dynamicize_schedule(torch.as_tensor(sched)))
    assert p.shape == sched.shape and p.dtype == np.float32
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-4)
    # the achieved trajectory tracks the commanded one
    assert np.abs(p - sched).max() < np.deg2rad(4.0)


# --- the invariants of tests/test_dynamics.py, on the port -------------------


def test_chain_matches_iiwa_fk():
    for q in [np.zeros(7, np.float32), Q0, -Q0 * 0.7]:
        q = torch.as_tensor(q)
        np.testing.assert_allclose(t2n(dyn.fk_flange(q)), t2n(iiwa.fk(q)), atol=1e-6)


def test_mass_matrix_spd_and_symmetric():
    M = t2n(dyn.mass_matrix(torch.as_tensor(Q0))).astype(np.float64)
    assert np.allclose(M, M.T, atol=1e-7)
    assert np.linalg.eigvalsh(M).min() > 0


def test_rnea_decomposition():
    q, qd, qdd = (torch.as_tensor(a) for a in (Q0, QDS[0], QDDS[0]))
    lhs = dyn.rnea(q, qd, qdd)
    rhs = dyn.mass_matrix(q) @ qdd + dyn.bias_forces(q, qd)
    np.testing.assert_allclose(t2n(lhs), t2n(rhs), rtol=1e-4, atol=1e-5)


def _free_fall(q, qd, h, n, gravity):
    for _ in range(n):
        qdd = dyn.forward_dynamics(q, qd, torch.zeros(7), gravity=gravity)
        qd = qd + h * qdd
        q = q + h * qd
    return q, qd


def test_energy_conserved_unforced():
    qd0 = torch.tensor([0.3, -0.2, 0.4, 0.1, -0.3, 0.2, 0.5])
    q0 = torch.as_tensor(Q0)
    q1, qd1 = _free_fall(q0, qd0, 1e-3, 300, torch.zeros(3))
    e0, e1 = float(dyn.kinetic_energy(q0, qd0)), float(dyn.kinetic_energy(q1, qd1))
    assert e1 == pytest.approx(e0, rel=0.02)


def test_gravity_passivity():
    q0 = torch.as_tensor(Q0)
    q1, qd1 = _free_fall(q0, torch.zeros(7), 5e-4, 200, None)
    pe0, pe1 = float(dyn.potential_energy(q0)), float(dyn.potential_energy(q1))
    ke1 = float(dyn.kinetic_energy(q1, qd1))
    assert pe1 < pe0  # fell
    assert pe0 == pytest.approx(pe1 + ke1, abs=0.05 * max(ke1, 1e-3) + 1e-3)


def test_pd_holds_posture_under_gravity():
    qs, taus = dyn.track_schedule(torch.as_tensor(Q0), torch.as_tensor(Q0).repeat(30, 1))
    assert np.abs(t2n(qs[-1]) - Q0).max() < np.deg2rad(3.0)
    assert np.all(np.abs(t2n(taus)) <= dyn.TORQUE_LIMITS + 1e-6)


def test_force_limit_saturates(monkeypatch):
    monkeypatch.setattr(dyn, "TORQUE_LIMITS", np.ones(7))
    qs, _ = dyn.track_schedule(torch.as_tensor(Q0), torch.as_tensor(Q0).repeat(30, 1))
    assert np.abs(t2n(qs[-1]) - Q0).max() > np.deg2rad(5.0)


def test_tracks_slow_schedule():
    traj = _ramp(60, 15)
    qs, _ = dyn.track_schedule(torch.as_tensor(Q0), torch.as_tensor(traj))
    assert np.abs(t2n(qs) - traj).max() < np.deg2rad(4.0)  # bounded lag while moving
    assert np.abs(t2n(qs[-1]) - traj[-1]).max() < np.deg2rad(1.0)


# --- the eval with --arm_dynamics 1 ------------------------------------------


def test_eval_size_schedules_match_jax():
    """A pick and a place schedule at the eval's own size, planned by the
    eval's planners in a nut scene (the object resting in the bin, its
    tracked DB grasps the candidates, the fixture the obstacle): the
    320-waypoint pick and the 240-waypoint place, each dynamicized by both
    packages, within 1e-4 rad on every waypoint."""
    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
    scene = rgs.setup_scene("nut", n_objects=2, render_hw=(96, 128), device="cpu")
    db = np.load("dataset/grasps/nut_train_0_complete_grasp.npz")
    ob = np.eye(4, dtype=np.float32)
    ob[2, 3] = 0.01
    grasps_cam = (np.linalg.inv(scene.cam) @ ob @ db["grasp_poses"][:64]).astype(np.float32)
    obs = scene.fix_pts_base.astype(np.float32)
    pick, plan, _, _ = rgs.plan_pick(scene, grasps_cam, list(range(64)), obs, 0)
    assert pick is not None
    pick_sched = rgs.pick_schedule(plan)
    ob_in_grasp = np.linalg.inv(db["grasp_poses"][pick]).astype(np.float32)
    place_sched, _ = rgs.plan_place(scene, ob_in_grasp, pick_sched[-1], obs, 0)
    assert pick_sched.shape == (320, 7) and place_sched.shape == (240, 7)
    for sched in (pick_sched, place_sched):
        p = t2n(simarm.dynamicize_schedule(torch.as_tensor(sched)))
        np.testing.assert_allclose(p, jarm.dynamicize_schedule(sched), rtol=0, atol=1e-4)
        assert np.abs(p - sched).max() > 1e-3  # the arm lags the plan


def test_eval_main_hands_the_executors_the_dynamicized_schedule(monkeypatch, capsys):
    """``main --arm_dynamics 1`` on the short schedules of
    ``tests/test_torch_eval_modes.py``: every schedule the arm executors
    step is the port's ``dynamicize_schedule`` of the planned one, bit for
    bit, and differs from the plan.  Against JAX's ``dynamicize_schedule``
    of the same plan it is within 1e-4 rad on every waypoint before JAX's
    own run departs by more than 1e-5 rad from itself with the start moved
    by 1e-7 rad.  The short schedules move the arm up to 1 rad a waypoint,
    so the servo saturates its torque limits and runs into joint limits;
    past that horizon one-ulp differences grow to millirads in either
    package, and the approach lies inside it."""
    from test_torch_eval_modes import _check_tallies, _short_main

    from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
    planned, stepped = [], []
    dynamicize = simarm.dynamicize_schedule
    monkeypatch.setattr(simarm, "dynamicize_schedule",
                        lambda qs: planned.append(t2n(qs)) or dynamicize(qs))
    for name in ("execute_pick_arm", "execute_place_arm"):
        executor = getattr(simarm, name)

        def record(*a, executor=executor, name=name, **k):
            stepped.append((name, t2n(a[5])))
            return executor(*a, **k)

        monkeypatch.setattr(rgs.simarm, name, record)
    c, printed = _short_main(monkeypatch, capsys, ["--arm_dynamics", "1"])
    _check_tallies(c, printed)
    assert c.num_attempts == 1 and stepped[0][0] == "execute_pick_arm"
    assert len(planned) == len(stepped) >= 1
    for plan, (name, run) in zip(planned, stepped):
        assert run.shape == plan.shape
        np.testing.assert_array_equal(run, t2n(dynamicize(torch.as_tensor(plan))))
        assert np.abs(run - plan).max() > 1e-3
        ref = jarm.dynamicize_schedule(plan)
        nudged, _ = jdyn.track_schedule(jnp.asarray(plan[0] + 1e-7), jnp.asarray(plan),
                                        dt=1.0 / 240)
        drift = np.abs(np.asarray(nudged) - ref).max(axis=1)
        horizon = int(np.argmax(drift > 1e-5)) if (drift > 1e-5).any() else len(plan)
        if name == "execute_pick_arm":
            assert horizon >= rgs.N_APP, horizon
        np.testing.assert_allclose(run[:horizon], ref[:horizon], rtol=0, atol=1e-4)
