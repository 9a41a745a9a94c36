"""The eval's modes beyond the arm-executed CSG loop, through the port's
``main`` on the CPU with the short schedules, small sampler and render of
``tests/test_torch_eval_loop.py::test_one_round_smoke``: the
floating-gripper baseline (``--use_arm 0``, ``--arm_exec 0``) and the
baked-grid geometry (``--obj_path``), one round of 2 objects and one
attempt each.  Each prints the tallies it returns.
"""
import pytest
import torch

from catgrasp_tpu_torch.config.loader import load_config
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs

torch.set_num_threads(2)
CANONICAL = "dataset/nut_canonical.npz"


def _short_main(monkeypatch, capsys, argv):
    """``main`` on the CPU with the short schedules and the small sampler and
    render of ``test_one_round_smoke``, one round of 2 objects and one
    attempt: returns (the tallies it returns, the tallies it prints)."""
    import functools
    for name, v in (("SETTLE_STEPS", 120), ("RESETTLE_STEPS", 10), ("N_APP", 40),
                    ("CLOSE_STEPS", 45), ("LIFT_STEPS", 10), ("N_LIFT_A", 10),
                    ("N_MOVE_P", 50), ("N_DROP_P", 10)):
        monkeypatch.setattr(rgs, name, v)
    cfg = dict(load_config("config_run.yml"), cone_grasp_smapler_n_sphere_dir=2,
               cone_grasp_smapler_approach_step=0.02, nocs_grasp_sampler_max_n_grasp=64)
    monkeypatch.setattr(rgs, "load_config", lambda name: cfg)
    monkeypatch.setattr(rgs, "simulate_grasp_rounds",
                        functools.partial(rgs.simulate_grasp_rounds, max_attempts_per_round=1,
                                          render_hw=(192, 256)))
    c = rgs.main(["--class_name", "nut", "--n_rounds", "1", "--n_objects", "2", "--seed", "0",
                  "--canonical", CANONICAL, "--device", "cpu", *argv])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("num_objects=")]
    assert len(line) == 1
    printed = {k: int(v) for k, v in (kv.split("=") for kv in line[0].split())}
    return c, printed


def _check_tallies(c, printed):
    tallies = {k: getattr(c, k) for k in ("num_objects", "num_attempts", "num_stable_grasp",
                                          "num_task_grasp_succ")}
    assert printed == tallies
    assert c.num_task_grasp_succ <= c.num_stable_grasp <= c.num_attempts <= 1
    assert 1 <= c.num_objects <= 2


@pytest.mark.parametrize("argv", [["--use_arm", "0"], ["--use_arm", "1", "--arm_exec", "0"]],
                         ids=["use_arm0", "arm_exec0"])
def test_floating_round_runs(monkeypatch, capsys, argv):
    """The floating-gripper baseline through ``main``: one attempt (the pick
    the first candidate in score order with ``--use_arm 0``, the IK + RRT
    gate's with ``--arm_exec 0``), a floating pick and ``place_and_drop``;
    the tallies it prints are the ones it returns, and the arm executors are
    never stepped."""
    def no_arm(*a, **k):
        raise AssertionError("the floating baseline stepped the arm")

    monkeypatch.setattr(rgs.simarm, "execute_pick_arm", no_arm)
    monkeypatch.setattr(rgs.simarm, "execute_place_arm", no_arm)
    plans = []
    plan_pick = rgs.plan_pick
    monkeypatch.setattr(rgs, "plan_pick", lambda *a, **k: plans.append(1) or plan_pick(*a, **k))
    c, printed = _short_main(monkeypatch, capsys, argv)
    _check_tallies(c, printed)
    assert c.num_attempts == 1
    assert bool(plans) == ("--arm_exec" in argv)


def test_grid_round_runs(monkeypatch, capsys):
    """``--obj_path``: the demo nut's mesh baked into a grid beside the
    fixture's, and one arm-executed attempt on grid geometry (the settle, the
    render, the executors and the re-settle on the grid narrowphase); the
    tallies it prints are the ones it returns."""
    geometries = set()
    step = rgs.engine.step

    def step_rec(*a, narrowphase="csg", **k):
        geometries.add(narrowphase)
        return step(*a, narrowphase=narrowphase, **k)

    monkeypatch.setattr(rgs.engine, "step", step_rec)
    render = rgs.raymarch.render
    monkeypatch.setattr(rgs.raymarch, "render",
                        lambda *a, **k: geometries.add("render " + k["geometry"]) or render(*a, **k))
    c, printed = _short_main(monkeypatch, capsys, ["--obj_path", "assets/nut_demo.obj"])
    _check_tallies(c, printed)
    assert geometries == {"grid", "render grid"}
