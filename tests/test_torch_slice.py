"""Port parity for the slice as a whole: the front half of one eval attempt
(render -> occupancy -> cone sample -> filter) on the same settled pile.

The JAX side mirrors ``simulate_grasp_rounds`` lines 484-604 with the JAX
package's functions; the port side calls
``pipelines.run_grasp_simulation.attempt_front``: with no canonical (the
cone sampler alone), and with a small canonical codebook (per segment the
oracle NUNOCS pose and the NOCS-transfer sampler beside the cone sampler,
found on the union of their candidates).  Both draw
the 512-point and 4,096-point subsamples from one numpy seed in the same
order.  The sample ids come from the JAX side (a ``jax.random`` stream
cannot be reproduced in torch) and are restricted to points whose Darboux
frame is well posed (see ``_well_posed_ids``).

Why the slice is held to agreement rather than equality: the two renders
reach each hit through differently ordered f32 arithmetic, so depths,
points and normals differ by ~1e-7 relative.  That can flip a decision that
sits on a threshold (a silhouette pixel, a voxel exactly at the observed
depth, a point exactly on a gripper box face).  Such ties are rare, hence
candidate-mask agreement >= 99.9% and each counter within 0.1% of JAX's.

These tests run the nut pile; ``tests/test_torch_slice_classes.py`` runs
the same checks on a screw pile and an hnm pile.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import transforms as jtf
from catgrasp_tpu.core.sampling import cone_directions
from catgrasp_tpu.core.symmetry import get_symmetry_tfs
from catgrasp_tpu.geom import occupancy as jocc
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.grasp import filter as jfilter
from catgrasp_tpu.grasp import sampler as jsampler
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.grasp.sampler import NocsTransferGraspSampler as JNocs
from catgrasp_tpu.pipelines.make_canonical import to_nunocs_transform
from catgrasp_tpu.render import raymarch as jraymarch
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import SceneParams as JSceneParams
from catgrasp_tpu.sim.types import SceneState as JSceneState
from catgrasp_tpu_torch.grasp.sampler import NocsTransferGraspSampler, PointConeGraspSampler
from catgrasp_tpu_torch.pipelines import run_grasp_simulation as rgs
from test_torch_common import np_fields, port_params, port_state, t2n

torch.set_num_threads(2)
H, W, FX = 48, 64, 300.0  # zoomed in so each nut covers ~100 pixels
GRID = (24, 24, 24)  # 8.3 mm voxels over the 0.2 m reach
SAMPLER = dict(max_num_samples=4, n_sphere_dir=4, approach_step=0.005)  # 900 poses
CANONICAL = "dataset/{}_canonical.npz"
# the canonical's best grasps: for the nut 64 x 12 symmetries = 768 poses
N_CODEBOOK = {"nut": 64, "screw": 1024, "hnm": 1024}


def _small_scene(cls="nut"):
    sc = rgs.setup_scene(cls, n_objects=3, render_hw=(H, W), device="cpu")
    sc.K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    sc.grid_dims = GRID
    return sc


def _well_posed_ids(pts, nrm, r_ball, m, stable):
    """``m`` sample ids among points whose frame is well posed: the pixel's
    normal is one both renders agree on (``stable``; at a hit ~1e-5 from a
    hex-prism edge the normal turns by 1e-3 for a 1e-7 shift of the hit),
    the smallest eigenvalue of the normal covariance is clearly below the next,
    and LAPACK's eigenvector (the JAX reference's solver) keeps its sign
    when the f32 covariance is nudged by a few ulps.  Elsewhere the answer
    turns on the covariance's last bits, which two summation orders do not
    share (a flat patch, or an off-diagonal entry at ~0 that steers a
    Householder reflection)."""
    from scipy.linalg import lapack
    P, N = jnp.asarray(pts), jnp.asarray(nrm)
    w = (jnp.sum((P[:, None] - P[None]) ** 2, axis=-1) <= r_ball * r_ball).astype(jnp.float32)
    cov = np.asarray(jnp.einsum("mn,ni,nj->mij", w, N, N))
    nudge = np.random.default_rng(3).choice([-4, 0, 4], (8, 3, 3)) * np.finfo(np.float32).eps

    def minor(c):
        c = ((c + c.T) / 2).astype(np.float32)
        ev, v, _ = lapack.ssyevd(c, compute_v=1, lower=1)
        return ev, v[:, 0]

    ok = []
    for i, c in enumerate(cov):
        if not stable[i]:
            continue
        ev, v0 = minor(c)
        if ev[1] - ev[0] <= 0.05 * ev[2]:
            continue
        if all(np.abs(minor(c * (1 + d))[1] - v0).max() < 1e-3 for d in nudge):
            ok.append(i)
    assert len(ok) >= m, "too few well-posed points"
    return np.random.default_rng(2).choice(ok, m, replace=False)


def _jax_front_half(sc, lib, state, params, env, rng, ids_out, stable_px, nocs=None,
                    cone_off=False):
    """The JAX package's attempt body (oracle, cone sampler and, given
    ``nocs``, the NOCS-transfer sampler on its plain "xla" collision path),
    with the cone sampler's ids chosen as documented above and recorded in
    ``ids_out``; ``stable_px`` (H, W) marks the pixels whose normals the
    renders share.  ``cone_off`` drops every cone candidate after the
    filter."""
    Kc = jnp.asarray(t2n(sc.K))
    out = jraymarch.render(lib, state, params, Kc, jnp.asarray(sc.cam), H, W, env=env)
    seg_body = np.asarray(out["seg"])
    xyz, normal = np.asarray(out["xyz"]), np.asarray(out["normal"])
    active = np.asarray(state.active)[:sc.n_objects]
    min_px = max(20, (H * W) // 2500)
    seg = seg_body
    seg_ids = sorted([i for i in range(sc.n_objects) if active[i]],
                     key=lambda i: -(seg == i).sum())
    cone = PointConeGraspSampler(sc.gripper, **SAMPLER)  # its settings only
    gripper = JGripper.default()
    tried = []
    for sid in seg_ids:
        m = seg == sid
        if m.sum() < min_px:
            break
        pts, nrm = xyz[m], normal[m]
        bg_m = ~m & (seg_body != -1)
        depth_img = np.asarray(out["depth"])
        occ_c, occ_m = jocc.background_cloud_from_depth(
            jnp.asarray(np.where(m, 0.0, depth_img)), Kc, jnp.asarray(seg), -1,
            grid_dims=GRID, pad=1e-3, center=jnp.asarray(pts.mean(0)), reach=0.1)
        occ_pts = np.asarray(occ_c)[np.asarray(occ_m)]
        bg = np.concatenate([xyz[bg_m], occ_pts.astype(np.float32)])
        if len(bg) > rgs.MAX_BACKGROUND_PTS:
            bg = bg[rng.choice(len(bg), rgs.MAX_BACKGROUND_PTS, replace=False)]
        n_sub = min(len(pts), rgs.MAX_COLLISION_PTS)
        ids = rng.choice(len(pts), n_sub, replace=False)
        P, N = pts[ids], nrm[ids]
        # PointConeGraspSampler.sample_grasp_poses, ids given
        sub_ids = np.random.default_rng(1).choice(n_sub, min(128, n_sub), replace=False)
        d2 = jnp.sum((jnp.asarray(P[sub_ids])[:, None] - jnp.asarray(P)[None]) ** 2, axis=-1)
        d2 = jnp.where(d2 < 1e-12, jnp.inf, d2)
        r_ball = 3.0 * jnp.median(jnp.sqrt(jnp.min(d2, axis=-1)))
        sample_ids = _well_posed_ids(P, N, r_ball, min(cone.max_num_samples, n_sub),
                                     stable_px[m][ids])
        ids_out.append((sample_ids, sub_ids))
        R0 = jsampler.darboux_frames(jnp.asarray(P), jnp.asarray(N),
                                     jnp.asarray(sample_ids), r_ball)
        dirs = cone_directions(max(cone.n_sphere_dir * 4, 100), cone.cone_half_angle)
        dirs = dirs[np.random.default_rng(0).choice(len(dirs), cone.n_sphere_dir,
                                                    replace=False)]
        poses = jsampler.augment_grasp_poses(
            R0, jnp.asarray(P[sample_ids]), jnp.asarray(dirs), float(gripper.init_bite),
            float(gripper.hand_depth), float(cone.approach_step), n_dirs=len(dirs),
            n_inplane=cone.n_inplane)
        T, valid, stats = jfilter.filter_grasp_poses(
            poses, jnp.eye(4)[None], jnp.eye(4), jnp.asarray(t2n(sc.cam_in_base)),
            jnp.asarray(gripper.ee_in_grasp), jnp.asarray(P), jnp.asarray(bg),
            jnp.ones(n_sub, bool), jnp.ones(len(bg), bool), spec=gripper.spec,
            filter_ik=True, chunk=128, adjust_depth=True)
        valid = np.asarray(valid) & (not cone_off)
        entry = {"seg": int(sid), "valid": valid, "T": np.asarray(T),
                 "stats": {k: int(v) for k, v in stats.items()}}
        cand, prov = [np.asarray(T)[valid]], [np.zeros(int(valid.sum()), np.int32)]
        if nocs is not None:
            ob_in_cam = np.linalg.inv(sc.cam) @ np.asarray(
                jtf.pose_from_qt(state.quat[sid], state.pos[sid]))
            mesh = jprim.make_instance(sc.class_name, "test", int(params.shape_id[sid]))
            T_nocs = to_nunocs_transform(mesh.vertices * float(params.scale[sid]))
            nocs_pose = (ob_in_cam @ np.linalg.inv(T_nocs)).astype(np.float32)
            poses_n, valid_n, _ = nocs.sample_grasps(
                jnp.asarray(nocs_pose), jnp.asarray(get_symmetry_tfs(sc.class_name)), bg,
                np.ones(len(bg), bool), P, np.ones(n_sub, bool),
                cam_in_world=jnp.asarray(t2n(sc.cam_in_base)), filter_ik=True, chunk=128,
                adjust_depth=True, backend="xla")
            valid_n = np.asarray(valid_n)
            entry.update(nocs_pose=nocs_pose, nocs_valid=valid_n, nocs_T=np.asarray(poses_n))
            cand.append(np.asarray(poses_n)[valid_n])
            prov.append(np.ones(int(valid_n.sum()), np.int32))
        entry.update(grasps_cam=np.concatenate(cand), prov=np.concatenate(prov))
        tried.append(entry)
        if len(entry["grasps_cam"]):
            break
    return out, tried


class _GivenIds(PointConeGraspSampler):
    """The cone sampler with its ids handed in, one (sample_ids, sub_ids)
    pair per filter call."""

    def __init__(self, queue, **kw):
        super().__init__(**kw)
        self.queue = list(queue)

    def draw_ids(self, points, generator):
        sample_ids, sub_ids = self.queue.pop(0)
        return torch.tensor(sample_ids), torch.tensor(sub_ids)


class _NoCone(_GivenIds):
    """``_GivenIds`` with every candidate dropped after the filter."""

    def sample_grasps(self, *args, **kw):
        poses, valid, stats = super().sample_grasps(*args, **kw)
        return poses, torch.zeros_like(valid), stats


def _settled(cls):
    """A 3-object pile of ``cls`` plus fixture, reset and stepped 60 times
    in JAX."""
    sc = _small_scene(cls)
    from catgrasp_tpu.geom import csg as jcsg
    from catgrasp_tpu.sim import arm as jarm
    from catgrasp_tpu.sim.types import build_shape_lib as jbuild
    fit = jprim.instance_params(cls, "test", 0)
    meshes = [jprim.make_instance(cls, "test", i) for i in range(sc.n_inst)]
    csgs = [jcsg.make_csg_instance(cls, "test", i) for i in range(sc.n_inst)]
    lib = jbuild(meshes + [jprim.place_fixture(cls, fit)],
                 csgs + [jcsg.csg_place_fixture(cls, fit)], n_surf=256)
    n = sc.n_objects
    params = JSceneParams.create(lib, jnp.array([0] * n + [sc.fixture_idx], jnp.int32),
                                 jnp.ones(n + 1))
    params = params.replace(mass=params.mass.at[n].set(1e9),
                            inertia=params.inertia.at[n].set(1e9),
                            friction=params.friction.at[n].set(0.1))
    cfg = jpile.PileConfig(max_bodies=n, scale_range=(0.9, 1.1))
    sp, _ = jpile.reset(jax.random.PRNGKey(1), lib, cfg, n_objects=jnp.int32(n))
    state = JSceneState(
        pos=jnp.concatenate([sp.pos.at[:, 2].add(-0.05), jnp.asarray(rgs.FIXTURE_POS)[None]]),
        quat=jnp.concatenate([sp.quat, jnp.array([[1.0, 0, 0, 0]])]),
        linvel=jnp.zeros((n + 1, 3)), angvel=jnp.zeros((n + 1, 3)),
        active=jnp.ones(n + 1, bool))
    env = jarm.merge_envs(jengine.StaticEnv.open_bin(cfg.bin_inner),
                          jengine.StaticEnv.boxes(jnp.array([[-0.1, -0.5, -0.006]]),
                                                  jnp.array([[0.15, 0.15, 0.005]])))
    step = jax.jit(jengine.step)
    for _ in range(60):
        state = step(state, params, lib, env)
    # the port's own set-up builds the same library and colliders
    for k, v in np_fields(lib).items():
        obj = sc.lib
        for part in k.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(t2n(obj), v, err_msg=k)
    for k, v in np_fields(env).items():
        np.testing.assert_array_equal(t2n(getattr(sc.env_bin, k)), v, err_msg=k)
    return sc, lib, state, params, env


@pytest.fixture(scope="module")
def settled():
    return _settled("nut")


def _stable_normals(sc, lib, state, params, env):
    from catgrasp_tpu_torch.render import raymarch as praymarch
    p = praymarch.render(sc.lib, port_state(state), port_params(params), sc.K,
                         torch.as_tensor(sc.cam), H, W, env=sc.env_bin)
    j = jraymarch.render(lib, state, params, jnp.asarray(t2n(sc.K)), jnp.asarray(sc.cam),
                         H, W, env=env)
    d = np.abs(t2n(p["normal"]) - np.asarray(j["normal"])).max(-1)
    assert (d < 1e-5).mean() > 0.99
    return d < 1e-5


def test_slice_matches_jax(settled):
    _check_slice(settled)


def _check_slice(settled):
    sc, lib, state, params, env = settled
    queue = []
    j_out, j_tried = _jax_front_half(sc, lib, state, params, env, np.random.default_rng(0),
                                     queue, _stable_normals(*settled))
    assert j_tried and j_tried[-1]["valid"].any(), "the JAX side found no candidates"
    sc.cone = _GivenIds(queue, gripper=sc.gripper, **SAMPLER)
    res = rgs.attempt_front(sc, port_state(state), port_params(params),
                             np.random.default_rng(0), generator=None)
    seg_j, seg_p = np.asarray(j_out["seg"]), t2n(res.out["seg"])
    assert (seg_j == seg_p).mean() > 0.995
    assert [t["seg"] for t in res.tried] == [t["seg"] for t in j_tried]
    assert res.found is not None and res.found.target == j_tried[-1]["seg"]
    for tp, tj in zip((t["cone"] for t in res.tried), j_tried):
        assert tp["n_candidates"] == len(tj["valid"]) == 4 * 25 * 9
        agree = (tp["valid"] == tj["valid"]).mean()
        assert agree >= 0.999, f"candidate masks agree on {agree:.4%}"
        for k, vj in tj["stats"].items():
            assert abs(tp["stats"][k] - vj) <= 1e-3 * vj, (k, tp["stats"][k], vj)
    # the candidate poses, where both sides kept the candidate: rendered
    # normals agree to 1e-5, which the covariance eigenvector amplifies by
    # 1/gap (gap >= 5%), hence 1e-4 rather than the sampler's 1e-5
    vp, vj = res.tried[-1]["cone"]["valid"], j_tried[-1]["valid"]
    both = vp & vj
    np.testing.assert_allclose(res.found.grasps_cam[both[vp]], j_tried[-1]["T"][both],
                               atol=1e-4)


@pytest.mark.parametrize("cone", ["on", "off"])
def test_slice_with_canonical_matches_jax(settled, cone):
    """With a canonical codebook, on the same pile and numpy draws: the
    segments tried, the oracle NUNOCS pose within 1e-6, both samplers'
    candidate masks (agreement >= 99.9%, as above), and the found segment's
    union of candidates, cone's first: provenance (0 cone, 1 NOCS transfer)
    equal, poses within 1e-4 where both sides kept them.  With the cone's
    candidates dropped on both sides (``off``), a segment is found on the
    NOCS-transfer candidates alone."""
    _check_slice_with_canonical(settled, cone)


def _check_slice_with_canonical(settled, cone):
    sc, lib, state, params, env = settled
    can = dict(np.load(CANONICAL.format(sc.class_name)))
    n_codebook = N_CODEBOOK[sc.class_name]
    j_nocs = JNocs(JGripper.default(), can["canonical_grasps"], can["canonical_grasp_scores"],
                   score_larger_than=0.95, max_n_grasp=n_codebook)
    queue = []
    _, j_tried = _jax_front_half(sc, lib, state, params, env, np.random.default_rng(0), queue,
                                 _stable_normals(*settled), nocs=j_nocs,
                                 cone_off=cone == "off")
    assert j_tried and j_tried[-1]["nocs_valid"].any(), "the JAX NOCS sampler kept nothing"
    p_nocs = NocsTransferGraspSampler(sc.gripper, can["canonical_grasps"],
                                      can["canonical_grasp_scores"], score_larger_than=0.95,
                                      max_n_grasp=n_codebook)
    cone_sampler = (_GivenIds if cone == "on" else _NoCone)(queue, gripper=sc.gripper, **SAMPLER)
    scp = dataclasses.replace(sc, cone=cone_sampler, nocs=p_nocs)
    res = rgs.attempt_front(scp, port_state(state), port_params(params),
                             np.random.default_rng(0), generator=None)
    assert [t["seg"] for t in res.tried] == [t["seg"] for t in j_tried]
    for tp, tj in zip(res.tried, j_tried):
        for mp, mj in ((tp["cone"]["valid"], tj["valid"]),
                       (tp["nocs"]["valid"], tj["nocs_valid"])):
            assert len(mp) == len(mj)
            agree = (mp == mj).mean()
            assert agree >= 0.999, f"candidate masks agree on {agree:.4%}"
    tj, tp = j_tried[-1], res.tried[-1]
    assert res.found is not None and res.found.target == tj["seg"]
    np.testing.assert_allclose(res.found.nocs_pose, tj["nocs_pose"], atol=1e-6)
    np.testing.assert_array_equal(res.found.prov, tj["prov"])
    both = np.concatenate([(tp["cone"]["valid"] & tj["valid"])[tp["cone"]["valid"]],
                           (tp["nocs"]["valid"] & tj["nocs_valid"])[tp["nocs"]["valid"]]])
    both_j = np.concatenate([(tp["cone"]["valid"] & tj["valid"])[tj["valid"]],
                             (tp["nocs"]["valid"] & tj["nocs_valid"])[tj["nocs_valid"]]])
    np.testing.assert_allclose(res.found.grasps_cam[both], tj["grasps_cam"][both_j], atol=1e-4)


def test_port_slice_runs_end_to_end():
    """The port alone, from a torch.Generator: set-up, pile, settle, attempt;
    the filter's counters must add up to its candidate count."""
    sc = _small_scene()
    sc.cone = PointConeGraspSampler(sc.gripper, **SAMPLER)
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    state, params = rgs.make_round_pile(sc, rng, g, settle_steps=40)
    assert bool(state.active[-1])  # the fixture stays active
    res = rgs.attempt_front(sc, state, params, rng, g)
    assert res.out["depth"].shape == (H, W) and torch.isfinite(res.out["xyz"]).all()
    assert res.tried, "no segment was large enough to sample"
    for t in (t["cone"] for t in res.tried):
        s = t["stats"]
        assert (s["n_approach_dir_rej"] + s["n_ik_rej"] + s["n_collision_rej"]
                + t["n_valid"]) == t["n_candidates"] == 900
    if res.found is not None:
        assert res.found.grasps_cam.shape == (res.tried[-1]["cone"]["n_valid"], 4, 4)
        assert (res.found.prov == 0).all()
