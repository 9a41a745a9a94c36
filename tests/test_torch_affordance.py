"""Port parity for affordance discovery: ``sim/env_semantic.py``
(``_gripper_sample_points``, ``try_grasp`` stage by stage and whole,
``accumulate_affordance``), ``core/transforms.py:interpolate_poses`` over
leading axes, and ``pipelines/generate_affordance.py``.

The grasps are nut train/0's: the side pinch of ``tests/test_semantic.py``
and 7 tracked DB grasps whose stored labels cover rets 0, 1 and 2, with the
instance's own fixture, as ``generate_affordance`` builds it.  JAX's
``try_grasp`` runs once, vmapped over the 8 (one compile).  Stage by stage
the port is fed JAX's own rollout outputs: the contact masks, ``blocked``
and the drop's start pose are equal, and from that start the drop's final
pose is within 1e-4 m with ``placed`` equal.  Whole, ``ret`` is equal on at
least 7 of 8 (3 of 4 for screw and hnm) and the contact masks on 99% of
the entries of grasps with equal ``ret``; physics is chaotic, so the whole
run is held by agreement, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_grasp as jeg
from catgrasp_tpu.sim import env_semantic as jes
from catgrasp_tpu.sim.types import SceneParams as JParams
from catgrasp_tpu.sim.types import SceneState as JState
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu_torch.core import transforms as tf
from catgrasp_tpu_torch.pipelines import generate_affordance as ga
from catgrasp_tpu_torch.sim import env_semantic as es
from catgrasp_tpu_torch.sim.env_grasp import GripperSpec
from test_torch_common import random_poses, t2n

torch.set_num_threads(2)
DB = "dataset/grasps/{}_train_0_complete_grasp.npz"
LABELS = "dataset/affordance/{}_train_0_affordance.npz"
SPEC = jeg.GripperSpec()


def _side_pinch():
    G = np.eye(4, dtype=np.float32)
    G[:3, 0], G[:3, 1] = [0, 0, -1], [1, 0, 0]
    G[:3, 2] = np.cross(G[:3, 0], G[:3, 1])
    G[2, 3] = GripperSpec().finger_len
    return G


def _grasps(cls: str, n: int) -> np.ndarray:
    """The first DB grasps by stored label, round robin over rets 2, 1, 0."""
    rets = np.load(LABELS.format(cls))["rets"]
    by_ret = [list(np.flatnonzero(rets == r)) for r in (2, 1, 0)]
    idx = []
    while len(idx) < n:
        for b in by_ret:
            if b and len(idx) < n:
                idx.append(b.pop(0))
    return np.load(DB.format(cls))["grasp_poses"][idx]


def _setup(cls: str):
    """Both packages' library and affordance points, built as
    ``generate_affordance`` builds them."""
    lib, aff, _ = ga.affordance_setup(cls, "train", 0, device="cpu")
    jmesh = jprim.make_instance(cls, "train", 0)
    ip = jprim.instance_params(cls, "train", 0)
    jlib = jbuild([jmesh, jprim.place_fixture(cls, ip)],
                  [jcsg.make_csg_instance(cls, "train", 0), jcsg.csg_place_fixture(cls, ip)],
                  n_surf=64, seed=0)
    return lib, jlib, aff


def _jax_try_grasp(jlib, cls, aff, grasps):
    fn = jax.jit(jax.vmap(lambda G: jes.try_grasp(jlib, jnp.int32(0), jnp.int32(1),
                                                  jnp.float32(1.0), G, cls, jnp.asarray(aff),
                                                  SPEC)))
    r, m = fn(jnp.asarray(grasps))
    return np.asarray(r), np.asarray(m)


@pytest.fixture(scope="module")
def nut():
    lib, jlib, aff = _setup("nut")
    grasps = np.concatenate([_side_pinch()[None], _grasps("nut", 7)]).astype(np.float32)
    rets, masks = _jax_try_grasp(jlib, "nut", aff, grasps)
    return lib, jlib, aff, grasps, rets, masks


@pytest.fixture(scope="module")
def nut_stages(nut):
    """JAX's rollout of the 8 grasps, then its stages after the rollout (the
    body of its ``try_grasp``), one vmapped call each."""
    lib, jlib, aff, grasps, _, _ = nut
    roll = jax.jit(jax.vmap(lambda G: jeg.grasp_rollout(
        jlib, jnp.int32(0), jnp.float32(1.0), G, SPEC)))(jnp.asarray(grasps))
    pre_t, place_t = [jnp.asarray(t, jnp.float32) for t in jes.TASK_POSES["nut"]]

    def stages(G, r):
        drift = r["ob_pose_close"]
        pts_g = jtf.transform_points(jtf.pose_inverse(G),
                                     jtf.transform_points(drift, jnp.asarray(aff)))
        m_pos, m_neg = jeg.finger_contact_points(pts_g, r["width"], SPEC, surface_tol=0.003,
                                                 center=r["center"])
        held0 = jtf.pose_from_rt(jnp.eye(3), pre_t) @ drift
        held1 = jtf.pose_from_rt(jnp.eye(3), place_t) @ drift
        path = jtf.interpolate_poses(held0, held1, jnp.linspace(0.0, 1.0, 8))
        fixture = jcsg.select_shape(jlib.csg, jnp.int32(1))
        grip = jes._gripper_sample_points(SPEC, r["width"], n_boxes=2, center=r["center"])

        def collides(ob_pose):
            gw = jtf.transform_points(ob_pose @ jtf.pose_inverse(drift) @ G, grip)
            return jnp.min(jcsg.csg_sdf(fixture, gw)) < 5e-4

        blocked = jnp.any(jax.vmap(collides)(path))
        return m_pos, m_neg, blocked, held1

    m_pos, m_neg, blocked, held1 = jax.jit(jax.vmap(stages))(jnp.asarray(grasps), roll)
    return ({k: np.asarray(v) for k, v in roll.items()}, np.asarray(m_pos), np.asarray(m_neg),
            np.asarray(blocked), np.asarray(held1))


def _jax_drop(jlib, release):
    """JAX's drop of the object from ``release`` onto the fixture (the body
    of its ``try_grasp``): the final object pose."""
    params = JParams.create(jlib, jnp.array([0, 1]), jnp.array([1.0, 1.0], jnp.float32))
    params = params.replace(mass=params.mass.at[1].set(1e9),
                            inertia=params.inertia.at[1].set(1e9),
                            friction=params.friction.at[1].set(0.1))
    floor = jengine.StaticEnv.boxes(jnp.array([[0.0, 0.0, -0.05]]),
                                    jnp.array([[0.5, 0.5, 0.05]]))

    def one(T):
        st = JState.create(2).replace(
            pos=jnp.stack([T[:3, 3], jnp.zeros(3)]),
            quat=jnp.stack([jtf.matrix_to_quat(T[:3, :3]), jtf.quat_identity()]),
            active=jnp.array([True, True]))
        fin = jengine.rollout(st, params, jlib, floor, 60, gravity=-9.8)
        return jtf.pose_from_qt(fin.quat[0], fin.pos[0])

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(release)))


def test_gripper_sample_points_fingers_offset_match_jax():
    """Fingers only, the midline off centre, one opening and a batch."""
    widths = np.array([0.021, 0.004, 0.05], np.float32)
    centers = np.array([0.0031, -0.0042, 0.0], np.float32)
    p = t2n(es._gripper_sample_points(GripperSpec(), torch.as_tensor(widths), n_boxes=2,
                                      center=torch.as_tensor(centers)))
    assert p.shape == (3, 64, 3)
    for i in range(3):
        j = np.asarray(jes._gripper_sample_points(SPEC, jnp.float32(widths[i]), n_boxes=2,
                                                  center=jnp.float32(centers[i])))
        np.testing.assert_allclose(p[i], j, rtol=0, atol=1e-7)


def test_interpolate_poses_over_leading_axes_matches_jax():
    rng = np.random.default_rng(3)
    T0, T1 = random_poses(rng, 5), random_poses(rng, 5)
    alphas = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    j = np.asarray(jax.vmap(lambda a, b: jtf.interpolate_poses(a, b, jnp.asarray(alphas)))(
        jnp.asarray(T0), jnp.asarray(T1)))
    p = t2n(tf.interpolate_poses(torch.as_tensor(T0), torch.as_tensor(T1),
                                 torch.as_tensor(alphas)))
    assert p.shape == (5, 8, 4, 4)
    np.testing.assert_allclose(p, j, rtol=0, atol=2e-6)
    # a single pair keeps its (K, 4, 4) form
    p0 = t2n(tf.interpolate_poses(torch.as_tensor(T0[0]), torch.as_tensor(T1[0]),
                                  torch.as_tensor(alphas)))
    np.testing.assert_array_equal(p0, p[0])


def test_stages_from_jax_rollout(nut, nut_stages):
    """The port's stages after the rollout, fed JAX's own rollout outputs:
    the contact masks, ``blocked`` and the drop's start pose equal JAX's."""
    lib, _, aff, grasps, _, _ = nut
    roll, m_pos, m_neg, blocked, held1 = nut_stages
    out = es.try_grasp_after_rollout(
        lib, {k: torch.tensor(v) for k, v in roll.items()}, 0, 1, 1.0,
        torch.as_tensor(grasps), "nut", torch.as_tensor(aff), GripperSpec(), drop_steps=0)
    np.testing.assert_array_equal(t2n(out["m_pos"]), m_pos)
    np.testing.assert_array_equal(t2n(out["m_neg"]), m_neg)
    np.testing.assert_array_equal(t2n(out["blocked"]), blocked)
    np.testing.assert_allclose(t2n(out["release"]), held1, rtol=0, atol=1e-7)
    # the cases reach both sides of each gate
    stable = (~roll["collided"] & (roll["displacement"] <= 0.2)
              & m_pos.any(-1) & m_neg.any(-1))
    assert stable.any() and (~stable).any() and blocked.any() and (~blocked).any()


def test_drop_from_jax_start(nut, nut_stages):
    """From JAX's drop start, 60 steps onto the fixture: the final object
    pose within 1e-4 m and ``placed`` equal."""
    lib, jlib, _, _, _, _ = nut
    held1 = nut_stages[4]
    j = _jax_drop(jlib, held1)
    p = t2n(es.drop_on_fixture(lib, 0, 1, 1.0, torch.tensor(held1)))
    np.testing.assert_allclose(p[:, :3, 3], j[:, :3, 3], rtol=0, atol=1e-4)
    place_t = np.asarray(jes.TASK_POSES["nut"][1], np.float32)
    jp = np.asarray(jax.vmap(lambda T: jes.place_success("nut", T, jnp.asarray(place_t)))(
        jnp.asarray(j)))
    pp = t2n(es.place_success("nut", torch.as_tensor(p), torch.as_tensor(place_t)))
    np.testing.assert_array_equal(pp, jp)
    assert jp.any()


def test_try_grasp_whole_nut(nut):
    lib, _, aff, grasps, j_rets, j_masks = nut
    rets, masks = es.try_grasp(lib, 0, 1, 1.0, torch.as_tensor(grasps), "nut",
                               torch.as_tensor(aff))
    rets, masks = t2n(rets), t2n(masks)
    assert rets.shape == (8,) and masks.shape == (8, len(aff)) and masks.dtype == bool
    assert set(j_rets.tolist()) == {0, 1, 2}
    same = rets == j_rets
    assert same.sum() >= 7, (rets, j_rets)
    assert (masks[same] == j_masks[same]).mean() >= 0.99


@pytest.mark.parametrize("cls", ["screw", "hnm"])
def test_try_grasp_whole_axis_classes(cls):
    """Screw and hnm (the axis check of the placement): 4 DB grasps."""
    lib, jlib, aff = _setup(cls)
    grasps = _grasps(cls, 4)
    j_rets, _ = _jax_try_grasp(jlib, cls, aff, grasps)
    rets, _ = es.try_grasp(lib, 0, 1, 1.0, torch.as_tensor(grasps), cls, torch.as_tensor(aff))
    assert (t2n(rets) == j_rets).sum() >= 3, (t2n(rets), j_rets)


@pytest.mark.parametrize("min_trials", [1, 3, 4, 10])
def test_accumulate_affordance_matches_jax(min_trials):
    """Exact, with points touched by exactly ``min_trials`` stable grasps
    and by one fewer."""
    rng = np.random.default_rng(min_trials)
    rets = rng.integers(0, 3, 40).astype(np.int8)
    masks = rng.random((40, 64)) < 0.1
    stable = np.flatnonzero(rets >= 1)
    masks[:, :2] = False
    masks[stable[:3], 0] = True  # exactly 3 stable touches
    masks[stable[:4], 1] = True  # exactly 4
    ja, jn = jes.accumulate_affordance(rets, masks, min_trials=min_trials)
    pa, pn = es.accumulate_affordance(rets, masks, min_trials=min_trials)
    assert pa.dtype == ja.dtype == np.float32
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pn, jn)
    assert (pn[0], pn[1]) == (3, 4) and np.all(pa[pn < min_trials] == 0.5)


def test_generate_affordance_main(nut, tmp_path, monkeypatch):
    """The 8 grasps through ``main`` on the CPU: chunk 4 (two dispatches)
    and chunk 8 write identical files; the keys and dtypes are those of the
    tracked file JAX's ``generate_affordance`` wrote for this instance, the
    points bit-equal to its; ``rets`` equal JAX's ``try_grasp`` on at least
    7 of 8.  The default output directory is the port's own, never
    ``dataset/affordance``."""
    _, _, _, grasps, j_rets, _ = nut
    db = {k: v for k, v in np.load(DB.format("nut")).items()}
    db["grasp_poses"] = grasps
    db_path = tmp_path / "db.npz"
    np.savez(db_path, **db)
    tracked = dict(np.load(LABELS.format("nut")))
    monkeypatch.chdir(tmp_path)
    outs = []
    for chunk in ("4", "8"):
        path = ga.main(["--grasp_db", str(db_path), "--chunk", chunk, "--device", "cpu"])
        assert path.startswith(ga.DEFAULT_OUT_DIR + "/") and "dataset/affordance/" not in path
        outs.append(dict(np.load(path)))
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert sorted(tracked) == sorted(outs[0])
    assert {k: v.dtype for k, v in tracked.items()} == {k: v.dtype for k, v in outs[0].items()}
    np.testing.assert_array_equal(outs[0]["points"], tracked["points"])
    assert (outs[0]["rets"] == j_rets).sum() >= 7
    assert int(outs[0]["try_grasp_version"]) == es.TRY_GRASP_VERSION == jes.TRY_GRASP_VERSION
