"""Port parity: the scene tools and the cluster reducers — ``sim/snapshot.py``
(``save_state``, ``restore_state``, ``save_scene_npz``,
``scene_from_record``), ``sim/env_pile.py:add_duplicate_object_on_pile``
and ``nn/cluster.py``'s ``connected_components`` and ``segment_*``
reducers, against the JAX package on the same numpy inputs.

``jax.random`` cannot be reproduced in torch, so the duplicate's poses are
JAX's draws carried in through ``draw_duplicate_poses``; with them the
state equals JAX's exactly and the parameters within f32 rounding.  A scene
record written by either package loads in the other, rotations compared
through their matrices (a quaternion's sign is a gauge), as
``tests/test_snapshot.py`` compares them.  On the CPU the port's engine is
deterministic, so resuming from a restored snapshot reproduces the same
future bit for bit (``tests/test_snapshot.py:21``)."""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.nn import cluster as jcluster
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim import snapshot as jsnapshot
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.core import transforms as ptf
from catgrasp_tpu_torch.nn import cluster as pcluster
from catgrasp_tpu_torch.pipelines import generate_pile_data as pgpd
from catgrasp_tpu_torch.sim import engine as pengine
from catgrasp_tpu_torch.sim import env_pile as ppile
from catgrasp_tpu_torch.sim import snapshot as psnapshot
from test_torch_common import np_fields, port_env, port_lib, port_params, port_state, t2n

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nut_scene():
    """``tests/test_snapshot.py``'s scene: one nut instance, 3 body slots,
    reset by JAX and settled 50 steps by JAX; with the port's copies."""
    lib = jbuild([jprim.make_instance("nut", "train", 0)],
                 [jcsg.make_csg_instance("nut", "train", 0)], n_surf=32)
    cfg = jpile.PileConfig(max_bodies=3)
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    state, params = jpile.reset(jax.random.PRNGKey(0), lib, cfg)
    state = jpile.settle_fixed(state, params, lib, env, cfg, 50)
    pcfg = ppile.PileConfig(max_bodies=3)
    return (lib, cfg, env, state, params), (port_lib(lib), pcfg, port_env(env),
                                            port_state(state), port_params(params))


def _rotations(quat):
    return t2n(ptf.quat_to_matrix(torch.as_tensor(np.array(quat))))


def test_rollback_is_exact(nut_scene):
    """Snapshot, step on, restore (on the CPU), step the same again: the
    same future bit for bit; the snapshot is a host copy that the steps
    leave as it was."""
    _, (lib, cfg, env, state, params) = nut_scene
    snap = psnapshot.save_state(state)
    assert all(getattr(snap, k).device.type == "cpu" for k in ("pos", "quat", "active"))
    later = ppile.settle_fixed(state, params, lib, env, cfg, 60)
    assert not torch.allclose(later.pos, snap.pos)
    restored = psnapshot.restore_state(snap, device="cpu")
    for k in ("pos", "quat", "linvel", "angvel", "active"):
        assert torch.equal(getattr(restored, k), getattr(snap, k))
        assert getattr(restored, k).data_ptr() != getattr(snap, k).data_ptr()
    later2 = ppile.settle_fixed(restored, params, lib, env, cfg, 60)
    for k in ("pos", "quat", "linvel", "angvel", "active"):
        assert torch.equal(getattr(later2, k), getattr(later, k)), k
    assert torch.equal(snap.pos, state.pos)  # the steps did not write into the snapshot


def test_restore_defaults_to_the_gpu(nut_scene):
    """``restore_state`` without a device puts the state on the GPU; where
    there is none it raises rather than stay on the host."""
    _, (_, _, _, state, _) = nut_scene
    snap = psnapshot.save_state(state)
    if torch.cuda.is_available():
        assert psnapshot.restore_state(snap).pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            psnapshot.restore_state(snap)


def test_save_state_equals_jax_snapshot(nut_scene):
    (_, _, _, jstate, _), (_, _, _, state, _) = nut_scene
    jsnap, psnap = jsnapshot.save_state(jstate), psnapshot.save_state(state)
    for k in ("pos", "quat", "linvel", "angvel", "active"):
        np.testing.assert_array_equal(t2n(getattr(psnap, k)), np.asarray(getattr(jsnap, k)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scene_file_roundtrip_across_packages(tmp_path, nut_scene, writer):
    """A record written by one package's ``save_scene_npz`` restores in both
    packages' ``scene_from_record``: positions within 1e-6, rotations within
    1e-5 through their matrices, velocities, flags, shapes and scales; the
    same record without velocities (a pile-data record) at rest."""
    (jlib, _, _, jstate, jparams), (lib, _, _, state, params) = nut_scene
    path = str(tmp_path / "scene.npz")
    if writer == "jax":
        jsnapshot.save_scene_npz(path, jstate, jparams, note="x")
    else:
        psnapshot.save_scene_npz(path, state, params, note="x")
    rec = dict(np.load(path))
    assert str(rec["note"]) == "x"
    assert {k: rec[k].dtype for k in ("ob_in_world", "shape_id", "scales", "active")} == \
        {"ob_in_world": np.float32, "shape_id": np.int32, "scales": np.float32,
         "active": np.bool_}
    js, jp = jsnapshot.scene_from_record(rec, jlib)
    ps, pp = psnapshot.scene_from_record(rec, lib)
    for restored_pos, restored_quat in ((np.asarray(js.pos), np.asarray(js.quat)),
                                        (t2n(ps.pos), t2n(ps.quat))):
        np.testing.assert_allclose(restored_pos, t2n(state.pos), atol=1e-6)
        np.testing.assert_allclose(_rotations(restored_quat), _rotations(t2n(state.quat)),
                                   atol=1e-5)
    np.testing.assert_allclose(t2n(ps.quat), np.asarray(js.quat), atol=1e-6)
    for k in ("linvel", "angvel", "active"):
        np.testing.assert_array_equal(t2n(getattr(ps, k)), np.asarray(getattr(js, k)))
        np.testing.assert_array_equal(t2n(getattr(ps, k)), t2n(getattr(state, k)))
    for k in ("shape_id", "scale", "mass", "inertia", "friction"):
        np.testing.assert_allclose(t2n(getattr(pp, k)), np.asarray(getattr(jp, k)), rtol=1e-6)
    rec.pop("linvel")
    rec.pop("angvel")
    ps, _ = psnapshot.scene_from_record(rec, lib)
    assert float(ps.linvel.abs().max()) == 0.0 and float(ps.angvel.abs().max()) == 0.0


def test_scene_from_record_reads_pile_data_records(tmp_path):
    """Records that the port's ``generate_scenes`` writes (no velocities)
    restore in both packages alike, at rest, with their active flags."""
    cfg = pgpd.load_config("config.yml")
    cfg["render_downscale"] = 0.02
    pgpd.generate_scenes("nut", "train", 2, str(tmp_path), cfg=cfg, settle_steps=4, batch=2,
                         device="cpu")
    lib = pgpd.category_lib("nut", "train", device="cpu")
    n = jprim.num_instances("nut", "train")
    jlib = jbuild([jprim.make_instance("nut", "train", i) for i in range(n)],
                  [jcsg.make_csg_instance("nut", "train", i) for i in range(n)], n_surf=48)
    for f in sorted(glob.glob(str(tmp_path / "*.npz"))):
        rec = dict(np.load(f))
        js, jp = jsnapshot.scene_from_record(rec, jlib)
        ps, pp = psnapshot.scene_from_record(rec, lib)
        np.testing.assert_allclose(t2n(ps.pos), np.asarray(js.pos), atol=1e-6)
        np.testing.assert_allclose(_rotations(t2n(ps.quat)), _rotations(np.asarray(js.quat)),
                                   atol=1e-5)
        np.testing.assert_array_equal(t2n(ps.active), rec["active"])
        assert float(ps.linvel.abs().max()) == 0.0
        np.testing.assert_array_equal(t2n(pp.shape_id), rec["shape_id"])
        np.testing.assert_allclose(t2n(pp.mass), np.asarray(jp.mass), rtol=1e-6)


# --------------------------------------------------------------------------
# add_duplicate_object_on_pile
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dup_scene():
    """``tests/test_gripper_assets.py``'s scene: two nut instances, 6 slots,
    3 active; JAX's duplicate of shape 1 at scale 1.1 twice, and its draws."""
    jlib = jbuild([jprim.make_instance("nut", "train", i) for i in range(2)],
                  [jcsg.make_csg_instance("nut", "train", i) for i in range(2)], n_surf=32)
    cfg = jpile.PileConfig(max_bodies=6)
    state, params = jpile.reset(jax.random.PRNGKey(0), jlib, cfg, n_objects=jnp.int32(3))
    state = state.replace(active=jnp.arange(6) < 3)
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = jax.random.split(key, 3)
    ix, iy, _ = cfg.bin_inner
    xy = jax.random.uniform(k1, (6, 2), minval=-1.0, maxval=1.0) * jnp.array([ix / 2, iy / 2])
    z = jax.random.uniform(k2, (6,), minval=0.05, maxval=0.3)
    draws = (np.asarray(jnp.concatenate([xy, z[:, None]], axis=1)),
             np.asarray(jtf.quat_normalize(jax.random.normal(k3, (6, 4)))))
    return jlib, cfg, key, state, params, draws


@pytest.mark.parametrize("with_lib", [True, False])
def test_add_duplicate_matches_jax_on_its_draws(dup_scene, monkeypatch, with_lib):
    jlib, cfg, key, jstate, jparams, draws = dup_scene
    lib = port_lib(jlib)
    j_st, j_par = jpile.add_duplicate_object_on_pile(key, jstate, jparams, jnp.int32(1),
                                                     jnp.float32(1.1), jnp.int32(2), cfg,
                                                     jlib if with_lib else None)
    monkeypatch.setattr(ppile, "draw_duplicate_poses",
                        lambda g, n, c, dev: tuple(torch.as_tensor(d) for d in draws))
    p_st, p_par = ppile.add_duplicate_object_on_pile(
        torch.Generator().manual_seed(1), port_state(jstate), port_params(jparams), 1, 1.1, 2,
        ppile.PileConfig(max_bodies=6), lib if with_lib else None)
    for k, v in np_fields(j_st).items():
        np.testing.assert_array_equal(t2n(getattr(p_st, k)), v, err_msg=k)
    for k, v in np_fields(j_par).items():
        np.testing.assert_allclose(t2n(getattr(p_par, k)), v, rtol=1e-6, err_msg=k)
    act = t2n(p_st.active)
    assert act.tolist() == [True] * 5 + [False]
    if with_lib:
        assert (t2n(p_par.shape_id)[3:5] == 1).all()
        np.testing.assert_allclose(t2n(p_par.scale)[3:5], 1.1)


def test_add_duplicate_draws_and_settles(dup_scene):
    """The port's own draws: inside the bin's footprint, 5 to 30 cm up, unit
    quaternions, the other slots untouched; then 100 settle steps finite."""
    jlib, _, _, jstate, jparams, _ = dup_scene
    lib = port_lib(jlib)
    cfg = ppile.PileConfig(max_bodies=6)
    state0, params0 = port_state(jstate), port_params(jparams)
    st, par = ppile.add_duplicate_object_on_pile(torch.Generator().manual_seed(3), state0,
                                                 params0, 1, 1.1, 2, cfg, lib)
    new = [3, 4]
    pos = t2n(st.pos)[new]
    assert (pos[:, 2] >= 0.05).all() and (pos[:, 2] <= 0.3).all()
    assert (np.abs(pos[:, :2]) <= 0.15).all()
    np.testing.assert_allclose(np.linalg.norm(t2n(st.quat), axis=-1), 1.0, atol=1e-6)
    for k in ("pos", "quat"):
        keep = [0, 1, 2, 5]
        np.testing.assert_array_equal(t2n(getattr(st, k))[keep], t2n(getattr(state0, k))[keep])
    env = pengine.StaticEnv.open_bin(cfg.bin_inner, device="cpu")
    settled = ppile.settle_fixed(st, par, lib, env, cfg, 100)
    assert torch.isfinite(settled.pos).all()


# --------------------------------------------------------------------------
# nn/cluster.py: connected_components and the segment reducers
# --------------------------------------------------------------------------


def test_connected_components_two_blobs(rng):
    """``tests/test_nn.py``'s two blobs: one label each, the blob's lowest
    index, as JAX labels them."""
    a = rng.normal(0, 0.002, (32, 3))
    b = rng.normal(0, 0.002, (32, 3)) + np.array([0.5, 0, 0])
    pts = np.concatenate([a, b]).astype(np.float32)
    lp = t2n(pcluster.connected_components(torch.from_numpy(pts), radius=0.02))
    lj = np.asarray(jcluster.connected_components(jnp.asarray(pts), radius=0.02))
    np.testing.assert_array_equal(lp, lj)
    assert set(lp[:32]) == {0} and set(lp[32:]) == {32}


def test_connected_components_partial_on_a_long_chain():
    """A 60-point chain with 1 cm spacing (radius 1.5 cm) and a mask: 16
    sweeps carry the least label 16 links along, not to convergence; the
    labels equal JAX's partial labels, masked points -1."""
    pts = np.zeros((60, 3), np.float32)
    pts[:, 0] = np.arange(60) * 0.01
    mask = np.ones(60, bool)
    mask[[7, 45]] = False
    lp = t2n(pcluster.connected_components(torch.from_numpy(pts), 0.015,
                                           torch.from_numpy(mask)))
    lj = np.asarray(jcluster.connected_components(jnp.asarray(pts), 0.015, jnp.asarray(mask)))
    np.testing.assert_array_equal(lp, lj)
    assert lp[7] == -1 and lp[45] == -1
    assert len(set(lp[8:45])) > 1  # not converged: a chain of 37 after the gap
    lp4 = t2n(pcluster.connected_components(torch.from_numpy(pts), 0.015,
                                            torch.from_numpy(mask), n_sweeps=4))
    lj4 = np.asarray(jcluster.connected_components(jnp.asarray(pts), 0.015,
                                                   jnp.asarray(mask), n_sweeps=4))
    np.testing.assert_array_equal(lp4, lj4)


def test_connected_components_random_cloud(rng):
    pts = rng.uniform(0, 0.2, (600, 3)).astype(np.float32)
    mask = rng.uniform(size=600) > 0.1
    lp = t2n(pcluster.connected_components(torch.from_numpy(pts), 0.02,
                                           torch.from_numpy(mask)))
    lj = np.asarray(jcluster.connected_components(jnp.asarray(pts), 0.02, jnp.asarray(mask)))
    np.testing.assert_array_equal(lp, lj)
    assert lp.dtype == np.int64 and 1 < len(np.unique(lp[mask]))


def test_segment_reducers_match_jax(rng):
    """``tests/test_nn.py``'s cases, and 500 points in 7 segments (6 used,
    negatives dropped): the mean within 1e-6, min and max exact, an empty
    segment +inf, -inf and 0."""
    v = torch.tensor([[1.0, 0], [3.0, 0], [10.0, 2]])
    np.testing.assert_allclose(t2n(pcluster.segment_mean(v, torch.tensor([0, 0, 1]), 2)),
                               [[2.0, 0], [10.0, 2.0]])
    v1 = torch.tensor([4.0, -1.0, 7.0, 2.0, 5.0])
    lab = torch.tensor([0, 0, 1, 1, -1])
    np.testing.assert_allclose(t2n(pcluster.segment_min(v1, lab, 2)), [-1.0, 2.0])
    np.testing.assert_allclose(t2n(pcluster.segment_max(v1, lab, 2)), [4.0, 7.0])

    vals = rng.normal(size=(500, 3)).astype(np.float32)
    labels = rng.integers(-2, 6, 500)  # segment 6 empty
    for name in ("segment_mean", "segment_min", "segment_max"):
        for x in (vals, vals[:, 0]):
            if name == "segment_mean" and x.ndim == 1:
                continue
            p = t2n(getattr(pcluster, name)(torch.from_numpy(x), torch.from_numpy(labels), 7))
            j = np.asarray(getattr(jcluster, name)(jnp.asarray(x), jnp.asarray(labels), 7))
            assert p.shape == j.shape and p.dtype == j.dtype
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-7, err_msg=name)
    assert np.isposinf(t2n(pcluster.segment_min(torch.from_numpy(vals), torch.from_numpy(labels),
                                                7))[6]).all()
    assert np.isneginf(t2n(pcluster.segment_max(torch.from_numpy(vals), torch.from_numpy(labels),
                                                7))[6]).all()
    assert (t2n(pcluster.segment_mean(torch.from_numpy(vals), torch.from_numpy(labels),
                                      7))[6] == 0).all()
