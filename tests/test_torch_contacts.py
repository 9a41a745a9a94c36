"""Port parity: the analytic grasp-quality metrics, the dexnet surface-window
features (``grasp/contacts.py``) and the SDF collision manager against the
JAX package on the same numpy inputs, within f32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.geom import collision_manager as jcm
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.geom.sdf import SdfGrid as JSdfGrid
from catgrasp_tpu.grasp import contacts as jct
from catgrasp_tpu.grasp import quality as jq
from catgrasp_tpu_torch.geom import collision_manager as pcm
from catgrasp_tpu_torch.geom.sdf import SdfGrid as PSdfGrid
from catgrasp_tpu_torch.grasp import contacts as pct
from catgrasp_tpu_torch.grasp import quality as pq
from test_torch_common import random_poses, t2n

torch.set_num_threads(2)


def _contact_sets(rng, G=12, C=10):
    pts = rng.normal(scale=0.02, size=(G, C, 3)).astype(np.float32)
    nrm = rng.normal(size=(G, C, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = rng.uniform(size=(G, C)) > 0.3
    mask[0, :] = False
    mask[1, 1:] = False  # one contact: no force closure
    return pts, nrm, mask


@pytest.mark.parametrize("n_dirs", [256, 512])
def test_epsilon_quality_batch_matches_jax(rng, n_dirs):
    pts, nrm, mask = _contact_sets(rng)
    j = np.asarray(jq.epsilon_quality_batch(jnp.asarray(pts), jnp.asarray(nrm),
                                            jnp.asarray(mask), 0.6, n_dirs=n_dirs))
    p = t2n(pq.epsilon_quality_batch(torch.from_numpy(pts), torch.from_numpy(nrm),
                                     torch.from_numpy(mask), 0.6, n_dirs=n_dirs))
    np.testing.assert_allclose(p, j, atol=1e-5)
    assert j[0] == j[1] == 0.0 and (j > 0).sum() >= 4


def test_antipodal_force_closure_and_isotropy_match_jax(rng):
    p1, n1, p2, n2 = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(4))
    n2[:16] = -n1[:16]  # antipodal-ish pairs along their own normals
    p2[:16] = p1[:16] + 0.03 * n1[:16]
    j_s = np.asarray(jq.antipodal_score(*map(jnp.asarray, (p1, n1, p2, n2))))
    p_s = t2n(pq.antipodal_score(*map(torch.from_numpy, (p1, n1, p2, n2))))
    np.testing.assert_allclose(p_s, j_s, atol=1e-6)
    j_fc = np.asarray(jq.force_closure(*map(jnp.asarray, (p1, n1, p2, n2)), mu=0.4))
    p_fc = t2n(pq.force_closure(*map(torch.from_numpy, (p1, n1, p2, n2)), mu=0.4))
    np.testing.assert_array_equal(p_fc, j_fc)
    assert 0 < j_fc.sum() < len(j_fc)

    pts, nrm, mask = _contact_sets(rng)
    j_iso = np.stack([np.asarray(jq.grasp_isotropy(jnp.asarray(a), jnp.asarray(b),
                                                   jnp.asarray(m)))
                      for a, b, m in zip(pts, nrm, mask)])
    p_iso = t2n(pq.grasp_isotropy(torch.from_numpy(pts), torch.from_numpy(nrm),
                                  torch.from_numpy(mask)))
    np.testing.assert_allclose(p_iso, j_iso, atol=1e-5)
    assert j_iso[0] == 0.0 and (j_iso > 0).sum() >= 4


def _grids(fn, lo=-0.05, hi=0.05, n=64):
    xs = np.linspace(lo, hi, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    v, low, sp = fn(X, Y, Z).astype(np.float32), np.full(3, lo, np.float32), xs[1] - xs[0]
    return (JSdfGrid(values=jnp.asarray(v), lower=jnp.asarray(low), spacing=jnp.float32(sp)),
            PSdfGrid(values=torch.from_numpy(v), lower=torch.from_numpy(low),
                     spacing=torch.tensor(sp, dtype=torch.float32)))


@pytest.fixture(scope="module")
def ellipsoid():
    """An ellipsoid with distinct axes (3, 2.2, 1.6 cm): curved everywhere,
    with a principal curvature axis the PCA alignment can find."""
    ax = np.array([0.03, 0.022, 0.016])
    return ax, _grids(lambda x, y, z: (np.sqrt((x / ax[0]) ** 2 + (y / ax[1]) ** 2
                                               + (z / ax[2]) ** 2) - 1.0) * ax.min())


def _ellipsoid_contacts(ax, rng, n=6):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * ax / np.linalg.norm(d * ax / ax, axis=1, keepdims=True)  # on the surface
    nrm = pts / ax ** 2
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts.astype(np.float32), nrm.astype(np.float32)


def test_tangent_frame_matches_jax(rng):
    n = rng.normal(size=(32, 3)).astype(np.float32)
    n[0] = [1.0, 0.0, 0.0]  # plane perpendicular to x: the y fallback
    direc = rng.normal(size=(32, 3)).astype(np.float32)
    for kw in ({}, {"align_axes": False}):
        j = jax.vmap(lambda a: jct.tangent_frame(a, **kw))(jnp.asarray(n))
        p = pct.tangent_frame(torch.from_numpy(n), **kw)
        for a, b in zip(p, j):
            np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-6)
    j = jax.vmap(jct.tangent_frame)(jnp.asarray(n), jnp.asarray(direc))
    p = pct.tangent_frame(torch.from_numpy(n), torch.from_numpy(direc))
    for a, b in zip(p, j):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-6)


def test_surface_windows_match_jax(ellipsoid, rng):
    """The SDF window, the projection window (without and with the PCA
    alignment, bilateral filter on) and the batch's features, six contacts
    on the ellipsoid."""
    ax, (jg, pg) = ellipsoid
    pts, nrm = _ellipsoid_contacts(ax, rng)
    jp, jn, tp, tn = jnp.asarray(pts), jnp.asarray(nrm), torch.from_numpy(pts), \
        torch.from_numpy(nrm)
    j = jax.vmap(lambda a, b: jct.surface_window_sdf(jg, a, b, 0.02, 11))(jp, jn)
    np.testing.assert_allclose(t2n(pct.surface_window_sdf(pg, tp, tn, 0.02, 11)),
                               np.asarray(j), atol=1e-6)
    for align in (False, True):
        kw = dict(width=0.02, num_steps=11, back_up=0.005, num_samples=96, align_pca=align)
        j = jax.vmap(lambda a, b: jct.surface_window_projection(jg, a, b, **kw))(jp, jn)
        p = pct.surface_window_projection(pg, tp, tn, **kw)
        np.testing.assert_allclose(t2n(p), np.asarray(j), atol=2e-5)
        assert (np.asarray(j) < pct.NO_CONTACT_DIST).mean() > 0.5
    jb = jct.surface_windows_batch(jg, jp, jn, 0.02, 11, back_up=0.005)
    pb = pct.surface_windows_batch(pg, tp, tn, 0.02, 11, back_up=0.005)
    # finite differences over 1.8 mm cells amplify the windows' f32
    # rounding by up to ~1/res^2: each feature is held to 1e-5 of its scale
    for name in jb._fields:
        j = np.asarray(getattr(jb, name))
        np.testing.assert_allclose(t2n(getattr(pb, name)), j, atol=1e-5 * np.abs(j).max(),
                                   err_msg=name)
    # the feature vector of one window, built from the same fields
    one = [np.asarray(x[0]) for x in jb]
    np.testing.assert_allclose(
        t2n(pct.SurfaceWindow(*map(torch.from_numpy, one)).asarray(1.0, 0.5, 0.5, 0.1)),
        np.asarray(jct.SurfaceWindow(*map(jnp.asarray, one)).asarray(1.0, 0.5, 0.5, 0.1)),
        rtol=1e-6)


def test_bilateral_filter_matches_jax(rng):
    img = rng.uniform(-0.01, 0.02, (9, 9)).astype(np.float32)
    j = jct.bilateral_filter(jnp.asarray(img), 0.01, 1.5)
    np.testing.assert_allclose(t2n(pct.bilateral_filter(torch.from_numpy(img), 0.01, 1.5)),
                               np.asarray(j), atol=1e-7)


def test_collision_manager_matches_jax(rng):
    """Two meshes and a cloud at poses that touch and poses that do not:
    every pair's distance and collision flag, and the any-collision test."""
    nut, screw = jprim.make_instance("nut", "train", 0), jprim.make_instance("screw", "train", 0)
    cloud = rng.normal(scale=0.004, size=(200, 3)).astype(np.float32)
    managers = [jcm.CollisionManager(dims=32, n_surf=128),
                pcm.CollisionManager(dims=32, n_surf=128, device="cpu")]
    for cm in managers:
        cm.register_mesh("nut", nut.vertices, nut.faces)
        cm.register_mesh("screw", screw.vertices, screw.faces)
        cm.register_cloud("scan", cloud)
    poses = random_poses(rng, 6, spread=0.03)
    pairs = [("nut", "screw"), ("screw", "scan"), ("nut", "scan")]
    flags = []
    for k in range(3):
        for cm in managers:
            cm.set_transform("nut", poses[2 * k])
            cm.set_transform("screw", poses[2 * k + 1])
        for a, b in pairs:
            dj = managers[0].min_distance_pair(a, b)
            dp = managers[1].min_distance_pair(a, b)
            assert dp == pytest.approx(dj, abs=1e-5)
            assert managers[1].in_collision(a, b, 1e-3) == managers[0].in_collision(a, b, 1e-3)
            flags.append(dj < 0)
        assert managers[1].is_any_collision() == managers[0].is_any_collision()
    assert any(flags) and not all(flags)
    with pytest.raises(ValueError):
        managers[1].register_cloud("scan2", cloud)
        managers[1].min_distance_pair("scan", "scan2")
