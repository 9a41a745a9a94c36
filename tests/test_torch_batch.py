"""Port parity of the scene-batch layer and of the throughput entry point:
``convert`` on (B, N, ...) fields, ``reset_batch`` against ``vmap(reset)``
(by distribution: the two random streams differ), ``make_pile_batch``,
``render_batch`` against a loop of ``render``, and
``catgrasp_tpu_torch.bench`` at small sizes on the CPU, its env-steps phase
held to the Pallas ``rollout_fused`` in interpret mode on the same inputs.
"""
import jax
import numpy as np
import pytest
import torch

from catgrasp_tpu.ops import fused_rollout as jfr
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu_torch import bench
from catgrasp_tpu_torch.render import raymarch as praymarch
from catgrasp_tpu_torch.sim import engine as pengine
from catgrasp_tpu_torch.sim import env_pile as ppile
from catgrasp_tpu_torch.sim import types as ptypes
from test_torch_common import (np_fields, pile_batch_jax, pile_scene_jax, port_env, port_lib,
                               port_params, port_state, t2n, top_camera)

torch.set_num_threads(2)
FIELDS = ("pos", "quat", "linvel", "angvel")


@pytest.fixture(scope="module")
def setup():
    cfg, lib, env, states, low, params = pile_batch_jax()
    return cfg, lib, env, states, low, params


def test_convert_carries_a_scene_batch_across_unchanged(setup):
    _, _, _, states, _, params = setup
    pstates, pparams = port_state(states), port_params(params)
    for tree, ported in ((states, pstates), (params, pparams)):
        for name, a in np_fields(tree).items():
            t = getattr(ported, name)
            assert tuple(t.shape) == a.shape and a.shape[:2] == (8, 4), name
            np.testing.assert_array_equal(t2n(t), a, err_msg=name)
    assert pstates.active.dtype == torch.bool and pparams.shape_id.dtype == torch.int64
    # stacking the scenes one by one gives the batch back, and indexing a scene out
    scenes = [ptypes.index_scenes(pstates, b) for b in range(8)]
    assert scenes[3].pos.shape == (4, 3)
    back = ptypes.stack_scenes(scenes)
    for f in FIELDS + ("active",):
        assert torch.equal(getattr(back, f), getattr(pstates, f)), f
    part = ptypes.index_scenes(pparams, slice(2, 5))
    assert part.inertia.shape == (3, 4, 3) and torch.equal(part.scale, pparams.scale[2:5])


def test_reset_batch_has_the_distributions_of_vmapped_reset(setup):
    _, lib, _, _, _, _ = setup
    plib = port_lib(lib)
    B, N = 4096, 10
    jcfg, pcfg = jpile.PileConfig(max_bodies=N), ppile.PileConfig(max_bodies=N)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    js, jp = jax.vmap(lambda k: jpile.reset(k, lib, jcfg))(keys)
    ps, pp = ppile.reset_batch(torch.Generator().manual_seed(5), plib, pcfg, B)
    ref_s, ref_p = port_state(js), port_params(jp)
    for ref, out in ((ref_s, ps), (ref_p, pp)):
        for f in np_fields(ref):
            a, b = getattr(ref, f), getattr(out, f)
            assert a.shape == b.shape and a.dtype == b.dtype, f
            assert b.is_contiguous(), f
    # what is not random is equal: drop heights, zero velocities
    assert torch.equal(ps.pos[..., 2], ref_s.pos[..., 2])
    assert not ps.linvel.any() and not ps.angvel.any()
    # the same ranges ...
    lo, hi = pcfg.scale_range
    assert float(pp.scale.min()) >= lo and float(pp.scale.max()) <= hi
    assert float(ps.pos[..., :2].abs().max()) <= 0.06
    assert int(pp.shape_id.min()) == 0 and int(pp.shape_id.max()) == plib.num_shapes - 1
    np.testing.assert_allclose(t2n(torch.linalg.vector_norm(ps.quat, dim=-1)), 1.0, atol=1e-5)
    # ... and the same distributions: n_objects uniform in 1..N a scene, as a
    # prefix of the bodies; moments of the scale, the jitter and the attitude
    n_obj_p, n_obj_j = t2n(ps.active.sum(1)), t2n(ref_s.active.sum(1))
    assert torch.equal(ps.active, torch.arange(N) < ps.active.sum(1, keepdim=True))
    hist_p = np.bincount(n_obj_p, minlength=N + 1)[1:] / B
    hist_j = np.bincount(n_obj_j, minlength=N + 1)[1:] / B
    assert n_obj_p.min() == 1 and n_obj_p.max() == N
    # 5 sigma of a 1/N bin at B draws is 0.023
    assert np.abs(hist_p - 1.0 / N).max() < 0.025 and np.abs(hist_p - hist_j).max() < 0.035
    for name, a, b in (("scale", pp.scale, ref_p.scale), ("xy", ps.pos[..., :2],
                                                          ref_s.pos[..., :2]),
                       ("quat", ps.quat, ref_s.quat)):
        assert abs(float(a.mean()) - float(b.mean())) < 5e-3, name
        assert abs(float(a.std()) - float(b.std())) < 5e-3, name
    # mass and inertia follow from shape and scale as in the JAX package
    again = ptypes.SceneParams.create(plib, pp.shape_id, pp.scale)
    assert torch.equal(again.mass, pp.mass) and torch.equal(again.inertia, pp.inertia)
    # a given n_objects holds for every scene; one scene of the batch is a scene
    fixed, _ = ppile.reset_batch(torch.Generator().manual_seed(1), plib, pcfg, 6, n_objects=3)
    assert fixed.active.sum(1).tolist() == [3] * 6
    one, one_p = ppile.reset(torch.Generator().manual_seed(1), plib, pcfg)
    assert one.pos.shape == (N, 3) and one_p.scale.shape == (N,)


def test_make_pile_batch_settles_into_the_bin(setup):
    cfg, lib, _, _, _, _ = setup
    plib = port_lib(lib)
    pcfg = ppile.PileConfig(max_bodies=3)
    states, params, env = ppile.make_pile_batch(torch.Generator().manual_seed(2), plib, pcfg, 4,
                                                settle_steps=60)
    assert states.pos.shape == (4, 3, 3) and params.scale.shape == (4, 3)
    assert env.center.shape[0] == 5
    act = states.active
    assert act.any() and torch.isfinite(states.pos).all()
    start, _ = ppile.reset_batch(torch.Generator().manual_seed(2), plib, pcfg, 4)
    assert bool((states.pos[..., 2][act] < start.pos[..., 2][act]).all())  # they fell
    assert float(states.pos[..., 2][act].min()) > -0.02  # and not through the floor
    # it is reset_batch followed by rollout_batch and the out-of-bin cull
    again = pengine.rollout_batch(start, params, plib, env, 60, dt=pcfg.dt)
    assert torch.equal(again.pos, states.pos)


def test_render_batch_equals_a_loop_of_render():
    lib, state, params, env = pile_scene_jax()
    plib, pstate, pparams, penv = port_lib(lib), port_state(state), port_params(params), \
        port_env(env)
    moved = pstate.replace(pos=pstate.pos + torch.tensor([0.01, -0.02, 0.0]),
                           active=torch.tensor([True, False, True]))
    states = ptypes.stack_scenes([pstate, moved])
    bparams = ptypes.stack_scenes([pparams, pparams])
    H, W = 24, 32
    K = torch.tensor([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1.0]])
    cam = torch.from_numpy(top_camera())
    out = praymarch.render_batch(plib, states, bparams, K, cam, H, W, env=penv)
    for b, st in enumerate((pstate, moved)):
        one = praymarch.render(plib, st, pparams, K, cam, H, W, env=penv)
        assert set(one) == set(out)
        for k, v in one.items():
            assert out[k].shape == (2,) + v.shape, k
            assert torch.equal(out[k][b], v), k
    assert (out["seg"][0] == 1).any() and not (out["seg"][1] == 1).any()
    # scene_chunk keeps its meaning: it must divide the batch, and changes nothing else
    chunked = praymarch.render_batch(plib, states, bparams, K, cam, H, W, env=penv, scene_chunk=1)
    assert all(torch.equal(chunked[k], out[k]) for k in out)
    three = ptypes.stack_scenes([pstate, moved, pstate])
    with pytest.raises(ValueError, match="scene_chunk 2 must divide batch 3"):
        praymarch.render_batch(plib, three, ptypes.stack_scenes([pparams] * 3), K, cam, H, W,
                               env=penv, scene_chunk=2)


def test_bench_runs_every_phase_on_the_cpu():
    keep = {}
    sps, eps = bench.bench_env_steps("cpu", batch=8, max_bodies=4, n_surf=16, steps_per_call=5,
                                     n_calls=1, keep=keep)
    cps = bench.bench_collision_gate("cpu", n_poses=512, n_points=256, n_calls=1, keep=keep)
    ips = bench.bench_ik_gate("cpu", n_poses=256, n_calls=1, keep=keep)
    rps = bench.bench_render("cpu", batch=1, hw=(32, 48), n_calls=1, keep=keep)
    rec = bench.record(torch.device("cpu"), sps, eps, cps, ips, rps)
    assert rec["metric"] == "pile_env_steps_per_sec" and rec["unit"] == "env_steps/s"
    assert set(rec) == {"metric", "value", "unit", "extra", "device"}
    assert set(rec["extra"]) == {"engine_env_steps_per_sec", "grasp_collision_checks_per_sec",
                                 "ik_gate_poses_per_sec", "labeled_render_frames_per_sec"}
    for rate in (rec["value"], *rec["extra"].values()):
        assert np.isfinite(rate) and rate > 0
    assert rec["device"] == {"platform": "cpu"}
    first, last = keep["env_first"], keep["env_last"]
    assert last.pos.shape == (8, 4, 3) and all(torch.isfinite(getattr(last, f)).all()
                                               for f in FIELDS)
    act = last.active
    assert bool((last.pos[..., 2][act] < first.pos[..., 2][act]).all())  # 10 steps of falling
    assert keep["hits"].shape == (512, 7) and keep["hits"].dtype == torch.bool
    assert keep["ik_ok"].shape == (256,) and keep["ik_ok"].dtype == torch.bool
    assert keep["frames"]["depth"].shape == (1, 32, 48)
    assert (keep["frames"]["seg"] >= 0).any()


def test_bench_env_phase_matches_pallas_interpret(setup):
    """The env-steps phase on JAX's reset (warm-up call + one timed call of 5
    steps, the state carried on) against the Pallas kernel called the same
    way, to the short-horizon tolerance of ``test_torch_fused_rollout``."""
    cfg, lib, env, _, low, params = setup
    plib, penv, plow, pparams = port_lib(lib), port_env(env), port_state(low), port_params(params)
    fused, unfused, last = bench.env_steps_phase(plib, penv, plow, pparams, cfg.dt,
                                                 steps_per_call=5, n_calls=1)
    assert fused > 0 and unfused > 0 and np.isfinite([fused, unfused]).all()
    j = low
    for _ in range(2):
        j = jfr.rollout_fused(j, params, lib, env, 5, dt=cfg.dt, interpret=True)
    act = np.asarray(j.active)
    err = {f: np.abs(t2n(getattr(last, f)) - np.asarray(getattr(j, f))).max(-1)[act]
           for f in FIELDS}
    worst = {f: float(e.max()) for f, e in err.items()}
    assert worst["pos"] < 1e-4 and worst["quat"] < 1e-3, worst
    assert worst["linvel"] < 1e-2 and worst["angvel"] < 1e-2, worst
    np.testing.assert_array_equal(t2n(last.active), act)
