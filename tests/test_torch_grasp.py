"""Port parity: the IK gate, the cone sampler's frames and poses, and the
grasp filter against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.grasp import filter as jfilter
from catgrasp_tpu.grasp import sampler as jsampler
from catgrasp_tpu.grasp.gripper import Gripper as JGripper
from catgrasp_tpu.kin import iiwa as jiiwa
from catgrasp_tpu_torch.grasp import filter as pfilter
from catgrasp_tpu_torch.grasp import sampler as psampler
from catgrasp_tpu_torch.grasp.gripper import Gripper as PGripper
from catgrasp_tpu_torch.kin import iiwa as piiwa
from test_torch_common import random_poses, t2n

torch.set_num_threads(2)


def _ik_poses(rng, n=2000):
    """Half FK-reachable poses (random joints within limits), half random
    workspace poses."""
    q = rng.uniform(-1, 1, (n // 2, 7)) * jiiwa.JOINT_LIMITS
    reach = np.asarray(jiiwa.fk(jnp.asarray(q, jnp.float32)))
    rand = random_poses(rng, n - n // 2, spread=0.8)
    rand[:, 2, 3] += 0.4
    return np.concatenate([reach, rand]).astype(np.float32)


def test_fk_matches_jax(rng):
    q = (rng.uniform(-1, 1, (64, 7)) * jiiwa.JOINT_LIMITS).astype(np.float32)
    for a, b in zip(jiiwa.fk_frames(jnp.asarray(q)), piiwa.fk_frames(torch.from_numpy(q))):
        np.testing.assert_allclose(t2n(b), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("n_psi", [16, 32])
def test_ik_feasible_matches_jax_exactly(rng, n_psi):
    Ts = _ik_poses(rng)
    j = np.asarray(jiiwa.ik_feasible(jnp.asarray(Ts), n_psi))
    p = t2n(piiwa.ik_feasible(torch.from_numpy(Ts), n_psi))
    np.testing.assert_array_equal(p, j)
    assert 0.2 < j.mean() < 0.9  # both outcomes well represented


def _cloud(rng, n=300):
    """A cylindrical patch with slightly noisy normals: every neighborhood
    covariance has a clear smallest eigenvalue (the axis direction), so the
    minor axis is well defined and f32 rounding of the covariance moves it
    by ~1e-7 (on a flat patch the smallest eigenvalue is double and any
    basis of its plane is a valid answer)."""
    uv = rng.uniform(-0.02, 0.02, (n, 2))
    z = 80.0 * uv[:, 0] ** 2
    pts = np.stack([uv[:, 0], uv[:, 1], z], -1).astype(np.float32)
    nrm = np.stack([-160.0 * uv[:, 0], np.zeros(n), np.ones(n)], -1)
    nrm += rng.normal(scale=0.02, size=nrm.shape)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def test_darboux_frames_and_augment_match_jax(rng):
    pts, nrm = _cloud(rng)
    ids = rng.choice(len(pts), 12, replace=False)
    r_ball = 0.006
    R_j = np.asarray(jsampler.darboux_frames(jnp.asarray(pts), jnp.asarray(nrm),
                                             jnp.asarray(ids), r_ball))
    R_p = t2n(psampler.darboux_frames(torch.from_numpy(pts), torch.from_numpy(nrm),
                                      torch.from_numpy(ids), r_ball))
    np.testing.assert_allclose(R_p, R_j, atol=1e-5)

    g = JGripper.default()
    from catgrasp_tpu.core.sampling import cone_directions
    dirs = cone_directions(120, 60.0)[:7]
    T_j = np.asarray(jsampler.augment_grasp_poses(
        jnp.asarray(R_j), jnp.asarray(pts[ids]), jnp.asarray(dirs), float(g.init_bite),
        float(g.hand_depth), 0.005, n_dirs=7, n_inplane=6))
    T_p = t2n(psampler.augment_grasp_poses(
        torch.from_numpy(R_p), torch.from_numpy(pts[ids]), torch.from_numpy(dirs),
        float(g.init_bite), float(g.hand_depth), 0.005, n_dirs=7, n_inplane=6))
    assert T_p.shape == (12 * 43 * 9, 4, 4)
    np.testing.assert_allclose(T_p, T_j, atol=1e-5)


def test_sampler_poses_match_jax_for_given_ids(rng):
    """The whole cone sampler (resolution estimate, frames, augment) for the
    same sample ids; JAX draws its ids from a key, the port's sampler takes
    them through ``draw_ids``."""
    import jax
    pts, nrm = _cloud(rng, 200)
    key = jax.random.PRNGKey(7)
    cone_j = jsampler.PointConeGraspSampler(JGripper.default(), max_num_samples=5,
                                            n_sphere_dir=4, approach_step=0.005)
    T_j = np.asarray(cone_j.sample_grasp_poses(key, jnp.asarray(pts), jnp.asarray(nrm)))
    k1, k2 = jax.random.split(key)
    ids = np.asarray(jax.random.choice(k1, len(pts), (5,), replace=False))
    sub = np.asarray(jax.random.choice(k2, len(pts), (128,), replace=False))

    class GivenIds(psampler.PointConeGraspSampler):
        def draw_ids(self, points, generator):
            return torch.tensor(ids), torch.tensor(sub)

    cone_p = GivenIds(PGripper.default(), max_num_samples=5, n_sphere_dir=4,
                      approach_step=0.005)
    T_p = t2n(cone_p.sample_grasp_poses(torch.from_numpy(pts), torch.from_numpy(nrm),
                                        generator=None))
    np.testing.assert_allclose(T_p, T_j, atol=1e-5)


def _filter_inputs(rng):
    """950 grasps x 2 symmetries around a small object in the camera frame:
    approaches near the camera axis at varied depths, rolls and lateral
    jitter, so every gate both passes and rejects some; a floor behind the
    object as the background cloud; the eval's camera-in-base transform."""
    G = 950
    obj = np.array([0.0, 0.0, 0.66], np.float32)
    a = np.concatenate([rng.uniform(-0.7, 0.7, (G, 2)), np.ones((G, 1))], 1)
    a[: G // 8, 2] = -1.0  # facing the camera: the approach gate rejects these
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    helper = rng.normal(size=(G, 3))
    y = np.cross(a, helper)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    z = np.cross(a, y)
    T = np.zeros((G, 4, 4), np.float32)
    T[:, :3, :3] = np.stack([a, y, z], -1)
    T[:, :3, 3] = (obj - a * rng.uniform(0.0, 0.05, (G, 1))
                   + rng.uniform(-0.012, 0.012, (G, 3)))
    T[:, 3, 3] = 1.0
    sym = np.stack([np.eye(4), np.diag([-1.0, -1.0, 1.0, 1.0])]).astype(np.float32)
    cloud = (rng.normal(scale=0.004, size=(300, 3)) + obj).astype(np.float32)
    bg = np.concatenate([rng.uniform(-0.08, 0.08, (500, 2)),
                         rng.uniform(0.672, 0.68, (500, 1))], 1).astype(np.float32)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam[:3, 3] = [0, 0, 0.7]
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [-0.559, -0.367, 0.052]
    cam_in_base = (np.linalg.inv(base) @ cam).astype(np.float32)
    return T, sym, cloud, bg, cam_in_base


@pytest.mark.parametrize("filter_ik,adjust_depth", [(True, True), (False, False)])
def test_filter_matches_jax(rng, filter_ik, adjust_depth):
    T, sym, cloud, bg, cam_in_base = _filter_inputs(rng)
    ee = JGripper.default().ee_in_grasp
    mc = rng.uniform(size=len(cloud)) > 0.1
    mb = np.ones(len(bg), bool)
    kw = dict(filter_ik=filter_ik, adjust_depth=adjust_depth, n_psi=16)
    Tj, vj, sj = jfilter.filter_grasp_poses(
        jnp.asarray(T), jnp.asarray(sym), jnp.eye(4), jnp.asarray(cam_in_base),
        jnp.asarray(ee), jnp.asarray(cloud), jnp.asarray(bg), jnp.asarray(mc),
        jnp.asarray(mb), **kw)  # backend "auto": the Pallas kernel, interpreted
    Tp, vp, sp = pfilter.filter_grasp_poses(
        torch.from_numpy(T), torch.from_numpy(sym), torch.eye(4),
        torch.from_numpy(cam_in_base), torch.from_numpy(ee), torch.from_numpy(cloud),
        torch.from_numpy(bg), torch.from_numpy(mc), torch.from_numpy(mb), **kw)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(t2n(vp), vj)
    assert {k: int(v) for k, v in sp.items()} == {k: int(v) for k, v in sj.items()}
    np.testing.assert_allclose(t2n(Tp), np.asarray(Tj), atol=1e-5)
    for k in ("n_approach_dir_rej", "n_collision_rej") + (("n_ik_rej",) if filter_ik else ()):
        assert int(sj[k]) > 0, k
    assert 0 < vj.sum(), {k: int(v) for k, v in sj.items()}
    np.testing.assert_array_equal(pfilter.compact_valid(Tp, vp), np.asarray(Tp)[vj])
