"""Port parity: K3's plain version against the Pallas ``rollout_fused`` in
interpret mode, and the batched engine against ``vmap(engine.rollout)``.

The fixture is that of ``tests/test_fused_rollout.py``: 8 scenes of up to 4
bodies (nut, screw) with 16 surface points, reset by JAX over the open bin.
The piles are dropped 5 cm lower so that contacts start within a few steps.

Both sides round phi and the normals to bf16 at the same place, so over a
few steps they differ only by the order of f32 sums (the JAX kernel sums
over the scene lanes' point axis, the port over a tensor axis) and by
``rsqrt``: 1 and 5 steps are held to 1e-4 m, 1e-3 (quaternion) and 1e-2
(velocities) on every active body.  Piles are chaotic over longer horizons,
so 20 steps are held to 1 cm / 0.05 and 150 steps to settle statistics, the
tolerances of the JAX package's own test of its kernel against its engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.ops import fused_rollout as jfr
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu_torch.ops import fused_rollout as pfr
from catgrasp_tpu_torch.sim import engine as pengine
from catgrasp_tpu_torch.sim import types as ptypes
from test_torch_common import (pile_batch_jax, port_env, port_lib, port_params, port_state,
                               t2n)

torch.set_num_threads(2)
FIELDS = ("pos", "quat", "linvel", "angvel")


@pytest.fixture(scope="module")
def setup():
    cfg, lib, env, states, low, params = pile_batch_jax()
    port = (port_lib(lib), port_env(env), port_state(states), port_state(low),
            port_params(params))
    return cfg, lib, env, states, low, params, port


def _errors(j, p):
    """Max |difference| per field over the active bodies, and the share of
    active bodies within the short-horizon tolerance."""
    act = np.asarray(j.active)
    err = {f: np.abs(t2n(getattr(p, f)) - np.asarray(getattr(j, f))).max(-1)[act]
           for f in FIELDS}
    within = ((err["pos"] < 1e-4) & (err["quat"] < 1e-3) & (err["linvel"] < 1e-2)
              & (err["angvel"] < 1e-2))
    return {f: float(e.max()) for f, e in err.items()}, float(within.mean())


@pytest.mark.parametrize("n_steps", [1, 5])
def test_plain_matches_pallas_interpret_short(setup, n_steps):
    cfg, lib, env, _, low, params, (plib, penv, _, plow, pparams) = setup
    j = jfr.rollout_fused(low, params, lib, env, n_steps, dt=cfg.dt, interpret=True)
    p = pfr.rollout_fused(plow, pparams, plib, penv, n_steps, dt=cfg.dt)
    err, within = _errors(j, p)
    assert within == 1.0, f"{within:.3f} of bodies within tolerance, max errors {err}"
    # the horizon includes contact: some active body is off free fall
    v_free = 9.8 * n_steps * cfg.dt
    act = np.asarray(j.active)
    assert (np.abs(np.asarray(j.linvel)[..., 2][act]) < 0.9 * v_free).any()
    # inactive bodies are left alone
    np.testing.assert_array_equal(t2n(p.pos)[~act], np.asarray(low.pos)[~act])
    np.testing.assert_array_equal(t2n(p.active), act)


def test_plain_matches_pallas_interpret_20_steps(setup):
    cfg, lib, env, states, _, params, (plib, penv, pstates, _, pparams) = setup
    j = jfr.rollout_fused(states, params, lib, env, 20, dt=cfg.dt, interpret=True)
    p = pfr.rollout_fused_plain(pstates, pparams, plib, penv, 20, dt=cfg.dt)
    err, _ = _errors(j, p)
    assert err["pos"] < 0.01, f"max position divergence {err['pos'] * 1e3:.3f} mm"
    assert err["quat"] < 0.05, f"max quaternion divergence {err['quat']}"


def test_plain_settles_like_pallas_interpret(setup):
    cfg, lib, env, states, _, params, (plib, penv, pstates, _, pparams) = setup
    j = jfr.rollout_fused(states, params, lib, env, 150, dt=cfg.dt, interpret=True)
    p = pfr.rollout_fused_plain(pstates, pparams, plib, penv, 150, dt=cfg.dt)
    act = np.asarray(j.active)
    zj, zp = np.asarray(j.pos[..., 2])[act], t2n(p.pos[..., 2])[act]
    assert abs(zj.mean() - zp.mean()) < 0.01
    assert zp.min() > -0.02  # nothing tunnelled
    vp = np.linalg.norm(t2n(p.linvel), axis=-1)[act]
    vj = np.linalg.norm(np.asarray(j.linvel), axis=-1)[act]
    assert vp.mean() < max(2 * vj.mean(), 0.05)


def test_plain_static_bodies_do_not_move(setup):
    cfg, _, _, _, _, _, (plib, penv, _, plow, pparams) = setup
    mass, inertia = pparams.mass.clone(), pparams.inertia.clone()
    mass[:, 0], inertia[:, 0] = 1e9, 1e9
    out = pfr.rollout_fused_plain(plow, pparams.replace(mass=mass, inertia=inertia), plib, penv,
                                  30, dt=cfg.dt)
    np.testing.assert_allclose(t2n(out.pos[:, 0]), t2n(plow.pos[:, 0]), atol=1e-6)
    np.testing.assert_array_equal(t2n(out.quat[:, 0]), t2n(plow.quat[:, 0]))
    assert float((out.pos[:, 1:] - plow.pos[:, 1:]).abs().max()) > 1e-3  # the rest fell


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_plain_keeps_a_ragged_batch(setup, batch):
    cfg, _, _, _, _, _, (plib, penv, _, plow, pparams) = setup
    st, pr = ptypes.index_scenes(plow, slice(0, batch)), ptypes.index_scenes(pparams,
                                                                             slice(0, batch))
    out = pfr.rollout_fused(st, pr, plib, penv, 5, dt=cfg.dt)
    for f in FIELDS:
        assert getattr(out, f).shape == getattr(st, f).shape
    # scenes do not interact: a scene alone gives what it gives in the batch
    full = pfr.rollout_fused(plow, pparams, plib, penv, 5, dt=cfg.dt)
    np.testing.assert_allclose(t2n(out.pos), t2n(full.pos[:batch]), atol=1e-7)


def test_plain_settle_is_dt_robust(setup):
    cfg, _, _, _, _, _, (plib, penv, pstates, _, pparams) = setup
    a = pfr.rollout_fused_plain(pstates, pparams, plib, penv, 120, dt=cfg.dt)
    b = pfr.rollout_fused_plain(pstates, pparams, plib, penv, 240, dt=cfg.dt / 2)
    act = t2n(a.active)
    za, zb = t2n(a.pos[..., 2])[act], t2n(b.pos[..., 2])[act]
    assert abs(za.mean() - zb.mean()) < 0.01, f"{za.mean():.4f} vs {zb.mean():.4f}"
    vb = np.linalg.norm(t2n(b.linvel), axis=-1)[act]
    assert vb.mean() < 0.1, f"pile still live at dt/2: {vb.mean():.3f} m/s"


def _points(seed, n=512):
    """Seeded local points around a 1 cm primitive, with exact zeros on each
    axis and on all axes (where sign(0) = 0 decides the normal)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    for k in range(3):
        p[k * 8:(k + 1) * 8, k] = 0.0
    p[24:28] = 0.0
    p[28:32, :2] = 0.0
    return p


@pytest.mark.parametrize("prim", ["box", "cyl", "hex"])
def test_primitive_sdf_and_normal_match_jax(prim):
    p = _points({"box": 0, "cyl": 1, "hex": 2}[prim])
    rng = np.random.default_rng(7)
    par = rng.uniform(0.004, 0.012, (3, len(p))).astype(np.float32)
    jfn, pfn, n_par = {"box": (jfr._box_sdfn_l, pfr.box_sdfn, 3),
                       "cyl": (jfr._cyl_sdfn_l, pfr.cyl_sdfn, 2),
                       "hex": (jfr._hex_sdfn_l, pfr.hex_sdfn, 2)}[prim]
    ref = jfn(*[jnp.asarray(p[:, k]) for k in range(3)],
              *[jnp.asarray(par[k]) for k in range(n_par)])
    out = pfn(*[torch.from_numpy(p[:, k]) for k in range(3)],
              *[torch.from_numpy(par[k]) for k in range(n_par)])
    for name, r, o in zip(("d", "nx", "ny", "nz"), ref, out):
        np.testing.assert_allclose(t2n(o), np.asarray(r), atol=1e-6, err_msg=f"{prim} {name}")
    assert np.isfinite(np.stack([t2n(o) for o in out])).all()


def test_csg_eval_matches_jax():
    """Every category shape (union and subtraction, all three primitives,
    empty slots), one shape per point."""
    p = _points(3, 600)
    shapes = [jcsg.make_csg_instance(c, "train", i)
              for c, i in (("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3))]
    sid = np.arange(len(p)) % len(shapes)
    types = np.stack([np.asarray(s.types) for s in shapes])[sid].T  # (S, L)
    ops = np.stack([np.asarray(s.ops) for s in shapes])[sid].T
    prm = np.stack([np.asarray(s.params) for s in shapes])[sid].transpose(1, 2, 0)  # (S, 3, L)
    off = np.stack([np.asarray(s.offsets) for s in shapes])[sid].transpose(1, 2, 0)
    ref = jfr._csg_evaln_l(*[jnp.asarray(p[:, k]) for k in range(3)],
                           jnp.asarray(types, jnp.float32), jnp.asarray(ops, jnp.float32),
                           jnp.asarray(prm), jnp.asarray(off), types.shape[0])
    out = pfr.csg_evaln(*[torch.from_numpy(p[:, k]) for k in range(3)],
                        torch.from_numpy(types), torch.from_numpy(ops),
                        torch.from_numpy(np.ascontiguousarray(prm)),
                        torch.from_numpy(np.ascontiguousarray(off)))
    for name, r, o in zip(("d", "nx", "ny", "nz"), ref, out):
        np.testing.assert_allclose(t2n(o), np.asarray(r), atol=1e-6, err_msg=name)
    assert (t2n(out[0]) < 0).any() and (t2n(out[0]) > 0).any()


def test_rollout_batch_matches_vmapped_engine(setup):
    cfg, lib, env, _, low, params, (plib, penv, _, plow, pparams) = setup
    j = jax.vmap(lambda s, p: jengine.rollout(s, p, lib, env, 5, dt=cfg.dt))(low, params)
    p = pengine.rollout_batch(plow, pparams, plib, penv, 5, dt=cfg.dt)
    for f in FIELDS:
        np.testing.assert_allclose(t2n(getattr(p, f)), np.asarray(getattr(j, f)), atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(t2n(p.active), np.asarray(j.active))


def test_one_scene_batch_equals_the_single_scene_engine(setup):
    cfg, _, _, _, _, _, (plib, penv, _, plow, pparams) = setup
    for b in (0, 5):
        st, pr = ptypes.index_scenes(plow, b), ptypes.index_scenes(pparams, b)
        one = pengine.rollout(st, pr, plib, penv, 8, dt=cfg.dt)
        bat = pengine.rollout_batch(ptypes.stack_scenes([st]), ptypes.stack_scenes([pr]),
                                    plib, penv, 8, dt=cfg.dt)
        for f in FIELDS + ("active",):
            assert torch.equal(getattr(one, f), getattr(bat, f)[0]), f
    with pytest.raises(ValueError, match="leading scene axis"):
        pengine.rollout_batch(st, pr, plib, penv, 1)


def test_rollout_fused_on_cpu_tensors_is_the_plain_version(setup):
    """CPU tensors take the plain version, bit for bit, and count no launch."""
    cfg, _, _, _, _, _, (plib, penv, _, plow, pparams) = setup
    assert pfr.MAX_SMEM_BYTES == 227 * 1024
    n0 = pfr.rollout_fused.launches
    a = pfr.rollout_fused(plow, pparams, plib, penv, 3, dt=cfg.dt)
    b = pfr.rollout_fused_plain(plow, pparams, plib, penv, 3, dt=cfg.dt)
    for f in FIELDS + ("active",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert pfr.rollout_fused.launches == n0


def test_tall_column_tunnels_the_floor_alike():
    """Known behaviour of the algorithm, not a port fault: the top body of a
    10-body column reaches the 1 cm floor at ~2 m/s (8 mm a step) and can pass
    through it.  The plain version lets the same bodies through as the Pallas
    kernel, at the throughput entry point's shapes (10 bodies x 32 points)."""
    from catgrasp_tpu.geom import primitives as jprim
    from catgrasp_tpu.sim import env_pile as jpile
    from catgrasp_tpu.sim.types import build_shape_lib as jbuild

    cfg = jpile.PileConfig(max_bodies=10)
    specs = [("nut", 0), ("screw", 0), ("hnm", 0), ("nut", 3)]
    lib = jbuild([jprim.make_instance(c, "train", i) for c, i in specs],
                 [jcsg.make_csg_instance(c, "train", i) for c, i in specs], n_surf=32)
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    keys = jax.random.split(jax.random.PRNGKey(0), 16)[12:14]
    states, params = jax.vmap(lambda k: jpile.reset(k, lib, cfg, n_objects=10))(keys)
    j = jfr.rollout_fused(states, params, lib, env, 110, dt=cfg.dt, interpret=True)
    p = pfr.rollout_fused_plain(port_state(states), port_params(params), port_lib(lib),
                                port_env(env), 110, dt=cfg.dt)
    zj, zp = np.asarray(j.pos[..., 2]), t2n(p.pos[..., 2])
    assert (zj < -0.02).sum() >= 1  # the fixture does show the behaviour
    np.testing.assert_array_equal(zp < -0.02, zj < -0.02)
    # the bodies that stayed rest on the floor in both
    np.testing.assert_allclose(zp[zp > -0.02].mean(), zj[zj > -0.02].mean(), atol=0.01)


@pytest.mark.parametrize("cls", ["nut", "screw", "hnm", "fixtures"])
def test_bound_radius_holds_every_point_inside_the_csg(cls):
    """The kernel skips a point outside a body's bounding sphere, so the
    sphere must hold every point of negative CSG distance: by the port's
    evaluator and by the JAX package's, for every instance of the class (and
    the three place fixtures), at several scales."""
    from catgrasp_tpu_torch.geom import csg as pcsg
    from catgrasp_tpu_torch.geom.primitives import _SPLITS

    if cls == "fixtures":
        pshapes = [pcsg.csg_place_fixture(c) for c in ("nut", "screw", "hnm")]
        jshapes = [jcsg.csg_place_fixture(c) for c in ("nut", "screw", "hnm")]
    else:
        specs = [(split, k) for split in ("train", "test")
                 for k in range(len(_SPLITS[(cls, split)]))]
        pshapes = [pcsg.make_csg_instance(cls, s, k) for s, k in specs]
        jshapes = [jcsg.make_csg_instance(cls, s, k) for s, k in specs]
    radius = t2n(pfr.csg_bound_radius(pcsg.stack_shapes(pshapes)))
    rng = np.random.default_rng(11)
    n_inside = 0
    for k, (ps, js) in enumerate(zip(pshapes, jshapes)):
        assert radius[k] > 0
        for scale in (0.7, 1.0, 1.45):
            # world points around the body, a quarter of them near the sphere
            p = rng.uniform(-1.3, 1.3, (4000, 3)) * radius[k] * scale
            d = rng.normal(size=(1000, 3))
            p[:1000] = d / np.linalg.norm(d, axis=1, keepdims=True) * radius[k] * scale \
                * rng.uniform(0.9, 1.1, (1000, 1))
            p = p.astype(np.float32)
            loc = torch.from_numpy(p / np.float32(scale))
            d_port = pfr.csg_evaln(loc[:, 0], loc[:, 1], loc[:, 2], ps.types[:, None],
                                   ps.ops[:, None], ps.params[:, :, None],
                                   ps.offsets[:, :, None])[0]
            d_jax = np.asarray(jcsg.csg_sdf(js, jnp.asarray(p / np.float32(scale))))
            inside = (t2n(d_port) < 0) | (d_jax < 0)
            n_inside += int(inside.sum())
            # the kernel's sphere is 0.1% and 1 um wider still
            assert (np.linalg.norm(p[inside], axis=1) <= radius[k] * scale).all(), (cls, k, scale)
    assert n_inside > 100
    # and the sphere is not idle: the farthest inside point comes close to it
    assert radius.max() < 0.1


def test_stage_plain_equals_prepare(setup):
    """The kernel gathers by shape id while it stages a scene; its staging
    written out in PyTorch gives ``prepare``'s tables exactly."""
    _, _, _, _, _, _, (plib, penv, _, plow, pparams) = setup
    mass = pparams.mass.clone()
    mass[1, 0] = 1e9  # a static body: no inverse mass or inertia
    pparams = pparams.replace(mass=mass)
    full = pfr.prepare(plow, pparams, plib, penv)
    for scene in (0, 1, 5):
        one = pfr.stage_plain(plow, pparams, plib, penv, scene)
        for f in ("body", "surf", "csg_i", "csg_f"):
            assert torch.equal(getattr(one, f)[0], getattr(full, f)[scene]), (scene, f)
        assert torch.equal(one.env, full.env)
    assert (full.body[1, 0, 2:6] == 0).all() and not plow.active.all()
    # a rotated and a disabled env box: the rotation to f32 rounding (the sum
    # of four squares may be taken in another order), the rest exactly
    quat = penv.quat.clone()
    quat[1] = torch.tensor([0.8, 0.3, -0.4, 0.33])
    enabled = penv.enabled.clone()
    enabled[2] = False
    env2 = penv.replace(quat=quat, enabled=enabled, vel=penv.vel + 0.1)
    one, full = pfr.stage_plain(plow, pparams, plib, env2, 0), pfr.prepare(plow, pparams, plib,
                                                                           env2)
    np.testing.assert_allclose(t2n(one.env), t2n(full.env), atol=2e-7)
    assert torch.equal(one.env[:, :6], full.env[:, :6])
    assert torch.equal(one.env[:, 15:], full.env[:, 15:])
    assert (one.env[2, :3] == 1e6).all() and (one.env[2, 15:18] == 0).all()
