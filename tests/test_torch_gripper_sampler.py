"""Port parity: the gripper's frames, boxes and asset directories
(``grasp/gripper.py``) and the samplers' object centering and
``CombinedGraspSampler`` (``grasp/sampler.py``) against the JAX package.

The repo holds no reference gripper directory, so both directions are
tested: a directory that JAX's ``save`` writes loads the same in both
packages, and the port's ``save`` loads in JAX's ``load``.  The samplers
run the grasp filter (K1's plain version on the CPU) and are held as
``tests/test_torch_pickplace.py`` holds the NOCS sampler: the valid masks
agree on >= 99.9% of candidates, the counters within 0.1%, kept poses within
1e-5.  The cone sampler's draws are JAX's, carried in through ``draw_ids``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.core import symmetry as jsym
from catgrasp_tpu.geom.mesh import TriMesh as JTriMesh
from catgrasp_tpu.grasp import sampler as jsampler
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.grasp.gripper import _load_rigid_tf as j_load_rigid_tf
from catgrasp_tpu_torch.grasp import sampler as psampler
from catgrasp_tpu_torch.grasp.gripper import Gripper as PGripper
from catgrasp_tpu_torch.grasp.gripper import _load_rigid_tf as p_load_rigid_tf
from test_torch_common import t2n

torch.set_num_threads(2)
SPEC_KEYS = ("max_width", "finger_len", "finger_thickness", "finger_depth", "palm_depth",
             "init_bite")
MESHES = ("gripper_air_tight.obj", "gripper_enclosed_air_tight.obj", "finger1.obj")


def _assert_same_gripper(p, j):
    for k in SPEC_KEYS:
        assert getattr(p.spec, k) == pytest.approx(getattr(j.spec, k), abs=1e-7), k
    np.testing.assert_array_equal(p.ee_in_grasp, j.ee_in_grasp)
    assert p.ee_in_grasp.dtype == j.ee_in_grasp.dtype == np.float32
    for m in ("mesh_open", "mesh_enclosed"):
        np.testing.assert_array_equal(getattr(p, m).vertices, getattr(j, m).vertices)
        np.testing.assert_array_equal(getattr(p, m).faces, getattr(j, m).faces)
    assert p.params == j.params


def test_jax_saved_directory_loads_alike_in_both(tmp_path):
    """JAX's ``save`` of a non-default gripper, loaded by both packages:
    spec, ``ee_in_grasp``, meshes and params equal; the spec within 1e-5 of
    the saved gripper's (the reference's own round trip)."""
    g = JGripper.default(max_width=0.05, finger_len=0.045)
    d = str(tmp_path / "gripper")
    g.save(d)
    assert sorted(os.listdir(d)) == sorted(MESHES + ("params.json", "T_grasp_gripper.tf"))
    j, p = JGripper.load(d), PGripper.load(d)
    _assert_same_gripper(p, j)
    for k in ("max_width", "finger_len", "finger_thickness", "finger_depth"):
        assert abs(getattr(p.spec, k) - getattr(g.spec, k)) < 1e-5, k
    np.testing.assert_allclose(p.ee_in_grasp, g.ee_in_grasp, atol=1e-6)


def test_port_saved_directory_loads_in_jax(tmp_path):
    """The port's ``save`` writes the files JAX's writes, text for text,
    and JAX's ``load`` reads them as it reads its own."""
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    JGripper.default().save(dj)
    PGripper.default().save(dp)
    for name in MESHES + ("params.json", "T_grasp_gripper.tf"):
        assert open(os.path.join(dp, name)).read() == open(os.path.join(dj, name)).read(), name
    _assert_same_gripper(PGripper.load(dp), JGripper.load(dp))
    assert len(JGripper.load(dp).mesh_open.vertices) == len(PGripper.default().mesh_open.vertices)


def test_rigid_tf_orientation_and_mismatch(tmp_path):
    """A transform stored the other way round is inverted as JAX inverts it;
    other frames raise in both packages."""
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [0.01, -0.02, 0.15]
    path = str(tmp_path / "T.tf")
    from catgrasp_tpu_torch.grasp.gripper import _save_rigid_tf
    _save_rigid_tf(path, T, "grasp", "gripper")
    for want in (("grasp", "gripper"), ("gripper", "grasp")):
        pj, pp = j_load_rigid_tf(path, want), p_load_rigid_tf(path, want)
        np.testing.assert_array_equal(pp, pj)
        assert pp.dtype == np.float32
    for load in (j_load_rigid_tf, p_load_rigid_tf):
        with pytest.raises(RuntimeError, match="frames"):
            load(path, ("gripper", "world"))
    gdir = str(tmp_path / "g")
    PGripper.default().save(gdir)
    _save_rigid_tf(os.path.join(gdir, "T_grasp_gripper.tf"), T, "gripper", "tool")
    with pytest.raises(RuntimeError, match="frames"):
        PGripper.load(gdir)


def test_frames_boxes_and_pose_mesh_match_jax(tmp_path):
    j, p = JGripper.default(), PGripper.default()
    np.testing.assert_array_equal(p.get_grasp_pose_in_gripper_base(),
                                  j.get_grasp_pose_in_gripper_base())
    for (pc, ph), (jc, jh) in ((p.open_boxes(device="cpu"), j.open_boxes()),
                               (p.enclosed_box(device="cpu"), j.enclosed_box())):
        np.testing.assert_allclose(t2n(pc), np.asarray(jc), atol=1e-7)
        np.testing.assert_allclose(t2n(ph), np.asarray(jh), atol=1e-7)
    assert tuple(p.open_boxes(device="cpu")[0].shape) == (3, 3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, 0.0, 0.7]
    T[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    j.save_grasp_pose_mesh(T, str(tmp_path / "j.obj"))
    p.save_grasp_pose_mesh(T, str(tmp_path / "p.obj"))
    assert open(tmp_path / "p.obj").read() == open(tmp_path / "j.obj").read()
    np.testing.assert_allclose(JTriMesh.load_obj(str(tmp_path / "p.obj")).vertices,
                               j.mesh_open.vertices @ T[:3, :3].T + T[:3, 3], atol=1e-6)


# --------------------------------------------------------------------------
# the samplers
# --------------------------------------------------------------------------

CAM = np.eye(4, dtype=np.float32)
CAM[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
CAM[:3, 3] = [0, 0, 0.7]
BASE = np.eye(4, dtype=np.float32)
BASE[:3, 3] = [-0.559, -0.367, 0.052]
CAM_IN_BASE = (np.linalg.inv(BASE) @ CAM).astype(np.float32)


def _assert_filtered_match(out_p, out_j):
    (Tp, vp, sp), (Tj, vj, sj) = out_p, out_j
    vj, vp = np.asarray(vj), t2n(vp)
    assert vj.shape == vp.shape and 0 < vj.sum() < len(vj), {k: int(v) for k, v in sj.items()}
    assert (vj == vp).mean() >= 0.999
    for k, v in sj.items():
        assert abs(int(sp[k]) - int(v)) <= 1e-3 * int(v), (k, int(sp[k]), int(v))
    both = vj & vp
    np.testing.assert_allclose(t2n(Tp)[both], np.asarray(Tj)[both], atol=1e-5)


def _patch(rng, n=400):
    """A curved patch 0.69 m in front of the camera, facing it, with slightly
    noisy normals (every neighborhood's covariance has a clear smallest
    eigenvalue), and the bin floor 2 cm behind it."""
    uv = rng.uniform(-0.02, 0.02, (n, 2))
    pts = np.stack([uv[:, 0], uv[:, 1], 0.69 - 80.0 * uv[:, 0] ** 2], -1).astype(np.float32)
    nrm = np.stack([160.0 * uv[:, 0], np.zeros(n), -np.ones(n)], -1)
    nrm += rng.normal(scale=0.02, size=nrm.shape)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    bg = rng.uniform([-0.1, -0.1, 0.71], [0.1, 0.1, 0.72], (2048, 3)).astype(np.float32)
    return pts, nrm.astype(np.float32), bg


def test_cone_sampler_centered_matches_jax(rng, monkeypatch):
    """The cone sampler with ``center_ob_between_gripper`` through the
    filter, JAX's sample ids carried in; and the centering itself on the
    candidates within 1e-6 of JAX's."""
    pts, nrm, bg = _patch(rng)
    key = jax.random.PRNGKey(5)
    kw = dict(max_num_samples=8, n_sphere_dir=6, approach_step=0.004)
    cone_j = jsampler.PointConeGraspSampler(JGripper.default(), **kw)
    out_j = cone_j.sample_grasps(key, jnp.asarray(pts), jnp.asarray(nrm), bg,
                                 np.ones(len(bg), bool), cam_in_world=jnp.asarray(CAM_IN_BASE),
                                 center_ob_between_gripper=True, adjust_depth=True,
                                 backend="xla")
    k1, k2 = jax.random.split(key)
    ids = np.asarray(jax.random.choice(k1, len(pts), (8,), replace=False))
    sub = np.asarray(jax.random.choice(k2, len(pts), (128,), replace=False))

    class GivenIds(psampler.PointConeGraspSampler):
        def draw_ids(self, points, generator):
            return torch.tensor(ids), torch.tensor(sub)

    cone_p = GivenIds(PGripper.default(), **kw)
    out_p = cone_p.sample_grasps(torch.from_numpy(pts), torch.from_numpy(nrm),
                                 torch.from_numpy(bg), torch.ones(len(bg), dtype=torch.bool),
                                 generator=None, cam_in_world=CAM_IN_BASE,
                                 center_ob_between_gripper=True, adjust_depth=True)
    _assert_filtered_match(out_p, out_j)
    raw = np.asarray(cone_j.sample_grasp_poses(key, jnp.asarray(pts), jnp.asarray(nrm))).copy()
    cj = np.asarray(jsampler.center_object_between_fingers(jnp.asarray(raw), jnp.asarray(pts)))
    monkeypatch.setattr(psampler, "CENTER_CHUNK", 100)  # several passes, the last ragged
    cp = t2n(psampler.center_object_between_fingers(torch.from_numpy(raw),
                                                    torch.from_numpy(pts)))
    assert len(raw) % 100
    np.testing.assert_allclose(cp, cj, atol=1e-6)
    assert np.abs(cj - raw).max() > 1e-4  # the centering moved the candidates


@pytest.fixture(scope="module")
def nocs_case():
    """The NOCS sampler case of ``tests/test_torch_pickplace.py``: 64 grasps
    of the nut canonical x its 12 symmetries under a NUNOCS pose in view."""
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
    bg = rng.uniform([-0.1, -0.1, 0.7], [0.1, 0.1, 0.72], (4096, 3)).astype(np.float32)
    call = dict(nocs_pose=nocs_pose, symmetry_tfs=jsym.get_symmetry_tfs("nut"),
                background_cloud=bg, background_mask=np.ones(len(bg), bool),
                collision_cloud=target, collision_mask=np.ones(512, bool),
                cam_in_world=CAM_IN_BASE, filter_ik=True, adjust_depth=True)
    return grasps, scores, call


def test_nocs_sampler_centered_codebook_matches_jax(nocs_case):
    """``center_ob_between_gripper`` zeroes each kept codebook grasp's
    object-in-grasp offset along the closing axis: the codebook equal to
    JAX's bit for bit, the caller's array untouched, and the filtered
    candidates held to JAX's."""
    grasps, scores, call = nocs_case
    before = grasps.copy()
    js = jsampler.NocsTransferGraspSampler(JGripper.default(), grasps, scores,
                                           score_larger_than=0.95,
                                           center_ob_between_gripper=True)
    ps = psampler.NocsTransferGraspSampler(PGripper.default(), grasps, scores,
                                           score_larger_than=0.95,
                                           center_ob_between_gripper=True)
    np.testing.assert_array_equal(ps.canonical_grasps, js.canonical_grasps)
    assert ps.canonical_grasps.dtype == js.canonical_grasps.dtype == np.float32
    np.testing.assert_array_equal(grasps, before)
    np.testing.assert_allclose(np.linalg.inv(ps.canonical_grasps)[:, 1, 3], 0.0, atol=1e-6)
    assert np.abs(np.linalg.inv(grasps)[:, 1, 3]).max() > 1e-4
    out_j = js.sample_grasps(**{k: jnp.asarray(v) if k in ("nocs_pose", "cam_in_world") else v
                                for k, v in call.items()}, chunk=128, backend="xla")
    out_p = ps.sample_grasps(**call)
    _assert_filtered_match(out_p, out_j)


def test_combined_sampler_matches_jax(nocs_case):
    """``CombinedGraspSampler`` of two NOCS samplers, one of them centred,
    called once with the same keyword arguments: the poses and valid masks
    concatenated in order and a list of both stats, held to JAX's."""
    grasps, scores, call = nocs_case

    def samplers(mod, gripper, **kw):
        return mod.CombinedGraspSampler([
            mod.NocsTransferGraspSampler(gripper, grasps, scores, score_larger_than=0.95),
            mod.NocsTransferGraspSampler(gripper, grasps, scores, score_larger_than=0.95,
                                         center_ob_between_gripper=True)])

    cj = samplers(jsampler, JGripper.default())
    cp = samplers(psampler, PGripper.default())
    Tj, vj, sj = cj.sample_grasps(**{k: jnp.asarray(v) if k in ("nocs_pose", "cam_in_world")
                                     else v for k, v in call.items()},
                                  chunk=128, backend="xla")
    Tp, vp, sp = cp.sample_grasps(**call)
    assert isinstance(sp, list) and len(sp) == len(sj) == 2
    assert Tp.shape == (2 * 64 * 12, 4, 4) and vp.shape == (2 * 64 * 12,)
    half = 64 * 12
    for i in range(2):
        _assert_filtered_match((Tp[i * half:(i + 1) * half], vp[i * half:(i + 1) * half], sp[i]),
                               (np.asarray(Tj)[i * half:(i + 1) * half],
                                np.asarray(vj)[i * half:(i + 1) * half], sj[i]))
    assert not np.allclose(t2n(Tp[:half]), t2n(Tp[half:]), atol=1e-4)
