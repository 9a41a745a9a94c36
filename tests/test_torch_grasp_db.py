"""Port parity: grasp-DB generation against the JAX package on the same
numpy inputs — the engine with per-scene env colliders, the close-and-shake
rollout, the perturbation scores, score-bin balancing, the DB's sampling
front end and the SDF bake of ``make_sdf``.

``jax.random`` cannot be reproduced in torch, so JAX's perturbation offsets
and sampler draws are carried over as data.  Physics is chaotic, so whole
rollouts are held by outcome (success on >= 90% of rollouts, scores within
2/trials on >= 90% of grasps); the rollout's first steps are held to the
engine tests' tolerance."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.geom import sdf as jsdf
from catgrasp_tpu.grasp import sampler as jsampler
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.pipelines import generate_grasp as jgg
from catgrasp_tpu.sim import arm as jarm
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_grasp as jeg
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.grasp import sampler as psampler
from catgrasp_tpu_torch.grasp.gripper import Gripper as PGripper
from catgrasp_tpu_torch.pipelines import generate_grasp as pgg
from catgrasp_tpu_torch.pipelines import make_sdf as pmake_sdf
from catgrasp_tpu_torch.sim import arm as parm
from catgrasp_tpu_torch.sim import engine as pengine
from catgrasp_tpu_torch.sim import env_grasp as peg
from catgrasp_tpu_torch.sim.types import stack_scenes
from test_torch_common import (pile_scene_jax, port_env, port_lib, port_params, port_state,
                               random_poses, t2n)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = jeg.GripperSpec()


@pytest.fixture(scope="module")
def nut():
    """The nut_train_0 scorer's library (64 surface points, seed 0, as
    ``generate_grasp`` builds it) and its stored v3 DB."""
    lib = jbuild([jprim.make_instance("nut", "train", 0)],
                 [jcsg.make_csg_instance("nut", "train", 0)], n_surf=64, seed=0)
    db = np.load(os.path.join(REPO, "dataset", "grasps", "nut_train_0_complete_grasp.npz"))
    return lib, port_lib(lib), db["grasp_poses"], db["scores"]


def _special_grasps(poses, scores):
    """A deep centred grasp (score 1), a miss (score 0) and an open-gripper
    collision (a score-1 grasp pushed 2 cm further along its approach, so the
    palm sits in the nut)."""
    deep = poses[np.argmax(scores >= 0.99)]
    miss = poses[np.argmax(scores <= 0.0)]
    hit = deep.copy()
    hit[:3, 3] += 0.02 * deep[:3, 0]
    return np.stack([deep, miss, hit]).astype(np.float32)


def test_batched_env_step_matches_per_scene_steps():
    """A pile step with one gripper a scene (batched env: the bin boxes
    shared, merged with per-scene gripper boxes) equals each scene stepped
    alone with its own unbatched env; the unbatched step with a gripper in
    the env holds to JAX's."""
    jlib, jstate, jparams, jenv_bin = pile_scene_jax()
    lib, state, params, env_bin = (port_lib(jlib), port_state(jstate), port_params(jparams),
                                   port_env(jenv_bin))
    rng = np.random.default_rng(3)
    B = 4
    T = random_poses(rng, B, spread=0.01)
    T[:, :3, 3] += np.asarray(jstate.pos[0])  # grippers around body 0
    width = rng.uniform(0.01, 0.05, B).astype(np.float32)
    center = rng.uniform(-0.004, 0.004, B).astype(np.float32)
    v = rng.uniform(0.0, 0.15, (2, B)).astype(np.float32)
    grip = np.array([True, False, True, False])

    def genv(i=slice(None)):
        t = torch.as_tensor
        return peg.gripper_env(t(T[i]), t(width[i]), t(center[i]), t(v[0][i]), t(v[1][i]),
                               SPEC, grip=t(grip[i]))

    states = stack_scenes([state] * B)
    paramss = stack_scenes([params] * B)
    batched = pengine.step(states, paramss, lib, parm.merge_envs(env_bin, genv()), gravity=-9.8)
    for i in range(B):
        one = pengine.step(state, params, lib, parm.merge_envs(env_bin, genv(i)), gravity=-9.8)
        for f in ("pos", "quat", "linvel", "angvel"):
            np.testing.assert_allclose(t2n(getattr(batched, f)[i]), t2n(getattr(one, f)),
                                       atol=1e-6, rtol=0)
        if i == 0:
            jg = jeg.gripper_env(jnp.asarray(T[0]), jnp.float32(width[0]), jnp.float32(center[0]),
                                 jnp.float32(v[0][0]), jnp.float32(v[1][0]), SPEC,
                                 grip=bool(grip[0]))
            j = jengine.step(jstate, jparams, jlib, jarm.merge_envs(jenv_bin, jg))
            np.testing.assert_allclose(t2n(one.pos), np.asarray(j.pos), atol=1e-5)
            np.testing.assert_allclose(t2n(one.linvel), np.asarray(j.linvel), atol=1e-4)
    free = pengine.step(state, params, lib, env_bin, gravity=-9.8)
    moved = np.abs(t2n(batched.linvel) - t2n(free.linvel)[None]).max(axis=(1, 2))
    assert (moved > 1e-3).sum() >= 2, f"the grippers barely touched the pile: {moved}"


def _jax_rollout_steps(lib, T, n_steps):
    """JAX's ``grasp_rollout`` step function, stepped ``n_steps`` times from
    its start on one grasp: [(state, width, center, touched) after each]."""
    params = JSceneParams.create(lib, jnp.int32(0)[None], jnp.float32(1.0)[None], friction=0.7)
    st = JSceneState.create(1).replace(active=jnp.array([True]))
    T = jnp.asarray(T)
    T_inv = jtf.pose_inverse(T)
    w, c, tch = jnp.asarray(SPEC.max_width), jnp.zeros(()), jeg.closing_touched_init()
    step = jax.jit(jengine.step)
    out = []
    for i in range(n_steps):
        closing = jnp.asarray(i < jeg.N_CLOSE_STEPS)
        R = jtf.quat_to_matrix(st.quat[0])
        pts_g = jtf.transform_points(T_inv, st.pos[0] + lib.surf_pts[0] * 1.0 @ R.T)
        w, c, tch, v_p, v_n = jeg.closing_step(pts_g, w, c, tch, closing, SPEC,
                                               jengine.DT)
        env = jeg.gripper_env(T, w, c, v_p, v_n, SPEC, 0.9, grip=~closing & tch[0] & tch[1])
        st = step(st, params, lib, env, jengine.DT, 0.0)
        out.append((st, w, c, tch))
    return out


def test_rollout_start_matches_jax(nut):
    """The first 1 and 5 steps of the rollout batch of three grasps (deep,
    miss, collision) against JAX's step function per grasp; the whole
    rollout's ``collided`` equals JAX's."""
    jlib, lib, poses, scores = nut
    G = _special_grasps(poses, scores)
    params, carry, collided = peg.grasp_rollout_start(lib, 0, 1.0, torch.from_numpy(G), SPEC)
    run = dict(n_close=peg.N_CLOSE_STEPS, spec=SPEC)
    after1 = peg.grasp_rollout_steps(lib, params, torch.from_numpy(G), carry, range(1), **run)
    after5 = peg.grasp_rollout_steps(lib, params, torch.from_numpy(G), after1, range(1, 5), **run)
    for g in range(len(G)):
        ref = _jax_rollout_steps(jlib, G[g], 5)
        for k, got in ((0, after1), (4, after5)):
            jst, jw, jc, jt = ref[k]
            np.testing.assert_allclose(t2n(got[0].pos[g]), np.asarray(jst.pos), atol=1e-6)
            np.testing.assert_allclose(t2n(got[0].quat[g]), np.asarray(jst.quat), atol=1e-5)
            np.testing.assert_allclose(t2n(got[0].linvel[g]), np.asarray(jst.linvel), atol=1e-4)
            np.testing.assert_allclose(float(got[1][g]), float(jw), atol=1e-6)
            np.testing.assert_allclose(float(got[2][g]), float(jc), atol=1e-6)
            np.testing.assert_array_equal(t2n(got[3][g]), np.asarray(jt))
    jout = jax.vmap(lambda T: jeg.grasp_rollout(jlib, jnp.int32(0), jnp.float32(1.0), T,
                                                SPEC))(jnp.asarray(G))
    np.testing.assert_array_equal(t2n(collided), np.asarray(jout["collided"]))
    assert t2n(collided).tolist() == [False, False, True]
    out = peg.grasp_rollout(lib, 0, 1.0, torch.from_numpy(G), SPEC)
    np.testing.assert_array_equal(t2n(out["success"]), np.asarray(jout["success"]))
    assert bool(out["success"][0]) and not bool(out["success"][2])


def test_whole_rollouts_and_scores_match_jax(nut, monkeypatch):
    """32 rollouts (4 grasps x 8 JAX perturbations): ``success`` agrees on
    >= 90%; ``perturbation_scores`` fed JAX's offsets is within 2/trials of
    JAX's ``perturbation_scores`` on >= 90% of grasps."""
    jlib, lib, poses, scores = nut
    idx = [int(np.argmin(np.abs(scores - s))) for s in (0.3, 0.5, 0.7, 0.9)]
    grasps = poses[idx].astype(np.float32)
    G, trials = len(grasps), 8
    key = jax.random.PRNGKey(11)
    offsets = np.asarray(jtf.random_uniform_magnitude(key, max_t=0.005, max_r_deg=10.0,
                                                      shape=(G, trials)))
    perturbed = np.einsum("gij,gtjk->gtik", grasps, offsets).astype(np.float32)
    j_succ = np.asarray(jeg.verify_grasp_batch(jlib, jnp.int32(0), jnp.float32(1.0),
                                               jnp.asarray(perturbed.reshape(-1, 4, 4)), SPEC,
                                               0.7)).reshape(G, trials)
    p_succ = t2n(peg.verify_grasp_batch(lib, 0, 1.0, torch.from_numpy(perturbed), SPEC))
    assert (p_succ == j_succ).mean() >= 0.9, (p_succ, j_succ)
    assert 0 < j_succ.mean() < 1  # both outcomes represented

    j_scores = np.asarray(jeg.perturbation_scores(key, jlib, jnp.int32(0), jnp.float32(1.0),
                                                  jnp.asarray(grasps), trials=trials, spec=SPEC))
    np.testing.assert_allclose(j_scores, j_succ.mean(axis=1), atol=1e-6)
    monkeypatch.setattr(peg.tf, "random_uniform_magnitude",
                        lambda *a, **k: torch.tensor(offsets))
    p_scores = t2n(peg.perturbation_scores(None, lib, 0, 1.0, torch.from_numpy(grasps),
                                           trials=trials, spec=SPEC))
    assert p_scores.shape == (G,) and p_scores.dtype == np.float32
    assert (np.abs(p_scores - j_scores) <= 2 / trials).mean() >= 0.9, (p_scores, j_scores)


def test_grid_rollouts_match_jax(nut):
    """The ``--obj`` path's scorer: rollouts through the baked-grid
    narrowphase agree with JAX's on >= 90% of 16 grasps."""
    jlib_csg, _, poses, scores = nut
    jlib = jbuild([jprim.make_instance("nut", "train", 0)], None, n_surf=64, seed=0,
                  bake_grids=True)
    lib = port_lib(jlib)
    G = poses[np.argsort(scores)[::256]].astype(np.float32)  # 16 across the score range
    j = np.asarray(jax.vmap(lambda T: jeg.grasp_rollout(jlib, jnp.int32(0), jnp.float32(1.0), T,
                                                        SPEC, narrowphase="grid")["success"])(
        jnp.asarray(G)))
    p = t2n(peg.verify_grasp(lib, 0, 1.0, torch.from_numpy(G), SPEC, narrowphase="grid"))
    assert (p == j).mean() >= 0.9, (p, j)
    assert 0 < j.mean() < 1


def test_balance_score_bins_matches_jax(rng):
    scores = np.concatenate([rng.uniform(0, 1, 300), np.ones(40), np.zeros(60)])
    db = {"grasp_poses": np.arange(len(scores)), "scores": scores.astype(np.float32)}
    bins = np.array([0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.01])
    j = jgg.balance_score_bins(db, bins, max_per_bin=30, seed=4)
    p = pgg.balance_score_bins(db, bins, max_per_bin=30, seed=4)
    np.testing.assert_array_equal(p["grasp_poses"], j["grasp_poses"])
    np.testing.assert_array_equal(p["scores"], j["scores"])
    assert len(p["scores"]) < len(scores)


SMALL_CFG = {"n_surface_points_db": 200, "max_num_surface_points": 12, "n_sphere_dir": 3,
             "approach_step": 0.006, "perturbation_trials": 2}


def test_db_front_end_matches_jax(monkeypatch):
    """``generate_complete_grasps`` at small settings on an hnm (its flat
    faces make the open gripper collide), the sampler's draws carried from
    JAX: the candidate poses within 1e-5 and the collision rejections
    equal.  JAX's scores are stubbed (the scorer is held above); the port
    scores its candidates on the CPU."""
    seen = {}
    orig = jsampler.PointConeGraspSampler.sample_grasps

    def recording(self, *a, **k):
        out = orig(self, *a, **k)
        seen["stats"] = {kk: int(vv) for kk, vv in out[2].items()}
        return out

    monkeypatch.setattr(jsampler.PointConeGraspSampler, "sample_grasps", recording)
    monkeypatch.setattr(jgg.eg, "perturbation_scores",
                        lambda key, lib, sid, sc, chunk, **k: jnp.zeros(chunk.shape[0]))
    j = jgg.generate_complete_grasps("hnm", "train", 1, JGripper.default(), SMALL_CFG, seed=3,
                                     max_candidates=48)

    k_sample, _ = jax.random.split(jax.random.PRNGKey(3))
    k1, k2 = jax.random.split(k_sample)
    ids = np.asarray(jax.random.choice(k1, 200, (12,), replace=False))
    sub = np.asarray(jax.random.choice(k2, 200, (128,), replace=False))
    monkeypatch.setattr(psampler.PointConeGraspSampler, "draw_ids",
                        lambda self, points, generator: (torch.tensor(ids), torch.tensor(sub)))
    info = {}
    p = pgg.generate_complete_grasps("hnm", "train", 1, PGripper.default(), SMALL_CFG, seed=3,
                                     max_candidates=48, trials=1, device="cpu", info=info)
    assert info["stats"]["n_collision_rej"] == seen["stats"]["n_collision_rej"] > 0
    assert info["stats"] == seen["stats"]
    assert p["grasp_poses"].shape == j["grasp_poses"].shape == (48, 4, 4)
    np.testing.assert_allclose(p["grasp_poses"], j["grasp_poses"], atol=1e-5)
    assert p["scores"].shape == (48,) and set(np.unique(p["scores"])) <= {0.0, 1.0}
    assert {k: p[k] for k in ("class_name", "split", "index")} == \
        {k: j[k] for k in ("class_name", "split", "index")}


def test_main_writes_both_dbs(tmp_path, monkeypatch):
    """``main`` on the CPU at small settings writes the complete and the
    balanced DB of one instance into ``--out_dir``."""
    monkeypatch.setattr(pgg, "load_config", lambda name: dict(
        SMALL_CFG, max_num_surface_points=2, n_sphere_dir=1, approach_step=0.02,
        perturbation_trials=1,
        classes=[0, 0.5, 1.01], max_per_score_bin=3))
    pgg.main(["--class_name", "nut", "--index", "2", "--out_dir", str(tmp_path),
              "--device", "cpu"])
    full = np.load(tmp_path / "nut_train_2_complete_grasp.npz")
    bal = np.load(tmp_path / "nut_train_2_balanced_grasp.npz")
    assert full["grasp_poses"].shape[1:] == (4, 4) and len(full["scores"]) > 3
    assert len(bal["scores"]) <= 6 and str(full["class_name"]) == "nut"


def test_make_sdf_one_matches_jax_bake():
    """``make_sdf_one`` on a nut within 2e-4 of JAX's ``bake_sdf`` at the
    same dims and padding (the native bake's tolerance against it)."""
    m = jprim.make_instance("nut", "train", 0)
    values, lower, spacing = pmake_sdf.make_sdf_one(m.vertices, m.faces, device="cpu")
    dims = values.shape[0]
    extent = float((m.vertices.max(0) - m.vertices.min(0)).max())
    assert dims == int(np.ceil(extent / 0.001)) + 10
    g = jsdf.bake_sdf(m.vertices, m.faces, dims=dims, padding=0.005, chunk=512)
    np.testing.assert_allclose(lower, np.asarray(g.lower), atol=1e-6)
    np.testing.assert_allclose(spacing, float(g.spacing), rtol=1e-6)
    np.testing.assert_allclose(values, np.asarray(g.values), atol=2e-4)
    assert (values < 0).any() and (values > 0).any()


def test_rescore_probe_matches_the_jax_script(nut):
    """The drift probe re-scores the subsample the JAX script draws, and
    ranks as its ``spearman_np`` does (ties by argsort)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "rescore_grasp_db_jax", os.path.join(REPO, "scripts", "rescore_grasp_db.py"))
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    from catgrasp_tpu_torch.pipelines import rescore_grasp_db as prdb
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 6, 200) / 5, rng.integers(0, 6, 200) / 5  # many ties
    assert prdb.spearman_np(a, b) == jscript.spearman_np(a, b)
    assert prdb.spearman_np(a, a) == pytest.approx(1.0)
    _, _, poses, scores = nut
    path = os.path.join(REPO, "dataset", "grasps", "nut_train_0_complete_grasp.npz")
    d, ids, stored, fresh, _ = prdb.rescore(path, n=3, trials=2, device="cpu")
    np.testing.assert_array_equal(ids, np.random.default_rng(0).choice(4096, 3, replace=False))
    np.testing.assert_array_equal(stored, scores[ids])
    assert fresh.shape == (3,) and set(np.unique(fresh)) <= {0.0, 0.5, 1.0}
    row = prdb.drift_row(path, stored, fresh, 2, 0.0)
    assert row["n"] == 3 and row["stored_mean"] == pytest.approx(float(stored.mean()))


def test_make_sdf_main_writes_grids_and_sdfgen_files(tmp_path):
    """``make_sdf.main`` on the CPU: one ``.npz`` grid and one SDFGen
    ``.sdf`` file an instance, the two holding the same grid."""
    from catgrasp_tpu_torch.geom import sdf_io
    pmake_sdf.main(["--class_name", "nut", "--splits", "test", "--write_sdf", "1",
                    "--out_dir", str(tmp_path), "--device", "cpu"])
    n = jprim.num_instances("nut", "test")
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"nut_test_{i}.{ext}" for i in range(n) for ext in ("npz", "sdf"))
    g = np.load(tmp_path / "nut_test_0.npz")
    values, origin, dx = sdf_io.read_sdf(str(tmp_path / "nut_test_0.sdf"))
    np.testing.assert_allclose(values, g["values"], atol=1e-6)
    np.testing.assert_allclose(origin, g["lower"], atol=1e-6)
    assert dx == pytest.approx(float(g["spacing"]), rel=1e-6)
