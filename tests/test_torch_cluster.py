"""Port parity for MeanShift (``nn/cluster.py``) and the RANSAC 9D fit
(``predict/ransac.py``) on the same inputs, with JAX's draws carried into
the port as data (the seed ids and the (1000, 4) hypothesis ids of
``jax.random.choice`` under the JAX functions' own keys).

Tolerances: MeanShift's labels and mode count equal, the modes within
1e-6 m (f32 sums in two orders); the RANSAC winner's inlier ratio and
inlier mask equal, and its transform within 1e-4 when the same hypothesis
wins (the port's 4x4 solve and SVD are LAPACK's as JAX's are on the CPU).
The port's own draws (``weighted_draw``) follow ``jax.random.choice``'s
rule: indices in proportion to the weights, none of weight 0, and index 0
for all-zero weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.nn.cluster import mean_shift as jmean_shift
from catgrasp_tpu.predict.ransac import estimate_9d_transform as jestimate
from catgrasp_tpu_torch.nn import cluster
from catgrasp_tpu_torch.predict import ransac
from test_torch_predict import jax_draws

torch.set_num_threads(2)


def _blobs(seed, n=3000, k=6, sigma=0.003):
    """``k`` Gaussian blobs of points in a 10 cm box, a fifth masked out."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 0.1, (k, 3))
    pts = centers[rng.integers(0, k, n)] + rng.normal(0, sigma, (n, 3))
    return pts.astype(np.float32), rng.random(n) > 0.2


@pytest.mark.parametrize("seed,bandwidth,n_seeds", [(0, 0.012, 64), (1, 0.007, 128),
                                                    (2, 0.02, 64)])
def test_mean_shift_matches_jax(monkeypatch, seed, bandwidth, n_seeds):
    pts, mask = _blobs(seed)
    lj, sj, nj = jmean_shift(jnp.asarray(pts), bandwidth, mask=jnp.asarray(mask),
                             n_seeds=n_seeds, key=jax.random.PRNGKey(0))
    jax_draws(monkeypatch)
    lp, sp, n_p = cluster.mean_shift(torch.as_tensor(pts), bandwidth,
                                     mask=torch.as_tensor(mask), n_seeds=n_seeds)
    assert int(n_p) == int(nj) >= 2
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=1e-6)
    assert (lp.numpy()[~mask] == -1).all()


def test_mean_shift_without_valid_points():
    """No valid point: every label -1, as in JAX (its seeds all draw point
    0); the port's own draw raises nothing."""
    pts, _ = _blobs(3, n=200)
    mask = np.zeros(200, bool)
    lj, _, _ = jmean_shift(jnp.asarray(pts), 0.01, mask=jnp.asarray(mask), n_seeds=16)
    lp, _, n_p = cluster.mean_shift(torch.as_tensor(pts), 0.01, mask=torch.as_tensor(mask),
                                    n_seeds=16, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    assert (lp == -1).all() and int(n_p) >= 1


def test_weighted_draw():
    """Indices in proportion to the weights (chi-square-free check: the
    share of each index within 0.01 of its weight over 200,000 draws), no
    index of weight 0, index 0 for all-zero weights, repeatable from a
    seeded generator."""
    p = torch.tensor([0.0, 0.1, 0.0, 0.6, 0.3])
    ids = cluster.weighted_draw(p, (200_000,), torch.Generator().manual_seed(0))
    share = torch.bincount(ids, minlength=5).double() / len(ids)
    assert torch.allclose(share, p.double(), atol=0.01) and share[0] == share[2] == 0
    again = cluster.weighted_draw(p, (200_000,), torch.Generator().manual_seed(0))
    assert torch.equal(ids, again)
    zeros = cluster.weighted_draw(torch.zeros(7), (5, 4), torch.Generator().manual_seed(1))
    assert zeros.shape == (5, 4) and (zeros == 0).all()


def _nocs_pair(seed, n=2048, noise=0.001, outliers=0.3):
    """A centered NUNOCS cloud and its image under a random rotation,
    per-axis scale and translation, with noise and a share of outliers."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (n, 3))
    R = Rotation.random(random_state=seed).as_matrix()
    tgt = (src * rng.uniform(0.01, 0.04, 3)) @ R.T + [0.05, -0.02, 0.7]
    tgt += rng.normal(0, noise, (n, 3))
    bad = rng.random(n) < outliers
    tgt[bad] += rng.normal(0, 0.02, (bad.sum(), 3))
    return src.astype(np.float32), tgt.astype(np.float32), rng.random(n) > 0.1


@pytest.mark.parametrize("seed,threshold", [(0, 0.003), (1, 0.005), (2, 0.003)])
def test_estimate_9d_transform_matches_jax(monkeypatch, seed, threshold):
    """The NUNOCS predicter's call (scales in [0.001, 0.5]) on a masked
    cloud: the best ratio, the inliers and the transform."""
    src, tgt, mask = _nocs_pair(seed)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    Tj, rj, ij = jestimate(key, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), threshold,
                           max_scale=jnp.array([0.5] * 3), min_scale=jnp.array([0.001] * 3))

    def draw(p, shape, generator=None):
        ids = jax.random.choice(key, p.shape[0], shape, replace=True, p=jnp.asarray(p.numpy()))
        return torch.as_tensor(np.array(ids), dtype=torch.int64)

    monkeypatch.setattr(ransac, "weighted_draw", draw)
    Tp, rp, ip = ransac.estimate_9d_transform(
        torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(mask), threshold,
        max_scale=torch.full((3,), 0.5), min_scale=torch.full((3,), 0.001))
    assert float(rp) == float(rj) > 0.3
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-4)


def test_estimate_9d_transform_rejects_degenerate_hypotheses():
    """Every hypothesis drawn from 4 copies of one point (a singular solve)
    or outside the scale gate scores 0, and nothing raises."""
    src, tgt, _ = _nocs_pair(5, n=64)
    mask = np.zeros(64, bool)
    mask[7] = True  # every draw is point 7: all four pairs equal
    Tp, rp, ip = ransac.estimate_9d_transform(
        torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(mask), 0.003,
        generator=torch.Generator().manual_seed(0))
    assert float(rp) == 0.0 and Tp.shape == (4, 4)
    Tp, rp, _ = ransac.estimate_9d_transform(
        torch.as_tensor(src), torch.as_tensor(tgt), torch.ones(64, dtype=torch.bool), 0.003,
        max_scale=torch.full((3,), 1e-4), generator=torch.Generator().manual_seed(0))
    assert float(rp) == 0.0
