"""Port parity for the three predicters (``predict/predicter.py``) on a
rendered pile cloud per class, with the tracked checkpoints loaded by each
package's ``load_predicters`` (the port through its own reader).

The pile is ``tests/test_torch_eval_loop.py``'s (3 objects, settled by
JAX), rendered by JAX at 192x256.  The device draws are JAX's, carried into
the port as data (``jax_draws``): the MeanShift seeds
(``PRNGKey(0)`` each seg predict) and the RANSAC hypotheses
(``fold_in(PRNGKey(0), i)`` for a NUNOCS predict's i-th threshold); the
numpy subsamples are the same ``default_rng(0)`` draws on both sides.

Tolerances: the seg net runs its convolutions in bfloat16 on both sides
(JAX's default), so the shifted points differ by bf16 rounding (a few 1e-4
m; JAX's jitted and op-by-op forwards differ by as much) and a seed near
the merge radius, or a point at a cluster's edge, can change its MeanShift
outcome.  So the seg predicter is held three ways: with JAX's net outputs
carried in as data, the labels equal; with its own net, its labels equal
on >= 99% those of JAX's net run op by op, each layer rounded as flax
declares it; and no further from the jitted JAX predicter's labels than
JAX's own two forwards are from each other.  The NUNOCS
and grasp nets run in f32: the NUNOCS bins equal, the valid flag and ratio
equal, the pose within 1e-5; the grasp distributions within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.nn import voxelnet as jvoxelnet
from catgrasp_tpu.predict.artifacts import load_predicters as jload_predicters
from catgrasp_tpu_torch.nn import cluster
from catgrasp_tpu_torch.predict import artifacts, ransac
from catgrasp_tpu_torch.predict.artifacts import load_predicters
from test_torch_common import port_params, port_state, t2n
from test_torch_eval_loop import _pile

torch.set_num_threads(2)


def eval_pile(cls):
    """(port scene on the CPU, JAX state, JAX params, the JAX render as
    numpy) of a settled 3-object pile of ``cls`` at 192x256."""
    sc, _, _, _, state, params, _, out = _pile(cls, hw=(192, 256), fx=600.0)
    return sc, state, params, out


def jax_draws(monkeypatch):
    """Make the port's device draws JAX's: every MeanShift seed draw is
    ``jax.random.choice(PRNGKey(0), ...)`` with the port's probabilities,
    and the i-th RANSAC draw from one ``torch.Generator`` (one NUNOCS
    predict) uses ``fold_in(PRNGKey(0), i)``."""
    seen = []  # [generator, draws so far]

    def draw(p, shape, generator=None):
        key = jax.random.PRNGKey(0)
        if len(shape) == 2:  # RANSAC hypotheses (N_HYPOTHESES, 4)
            entry = next((e for e in seen if e[0] is generator), None)
            if entry is None:
                entry = [generator, 0]
                seen.append(entry)
            key = jax.random.fold_in(key, entry[1])
            entry[1] += 1
        ids = jax.random.choice(key, p.shape[0], shape, replace=True, p=jnp.asarray(t2n(p)))
        return torch.as_tensor(np.array(ids), dtype=torch.int64, device=p.device)

    monkeypatch.setattr(cluster, "weighted_draw", draw)
    monkeypatch.setattr(ransac, "weighted_draw", draw)


def seg_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of points whose labels agree under the best one-to-one map of
    ``a``'s labels onto ``b``'s (-1, unlabelled, maps to -1), greedily by
    the largest overlap."""
    pairs = {}
    for x, y in zip(a.tolist(), b.tolist()):
        pairs[x, y] = pairs.get((x, y), 0) + 1
    used_a, used_b, agree = {-1}, {-1}, pairs.get((-1, -1), 0)
    for (x, y), c in sorted(pairs.items(), key=lambda kv: -kv[1]):
        if x not in used_a and y not in used_b:
            used_a.add(x)
            used_b.add(y)
            agree += c
    return agree / len(a)


@pytest.fixture(scope="module", params=["nut", "screw", "hnm"])
def pile_nets(request):
    cls = request.param
    _, _, _, out = eval_pile(cls)
    art = f"artifacts_tracked/{cls}"
    return cls, out, jload_predicters(art, cls), load_predicters(art, cls, device="cpu")


def test_seg_predicter_matches_jax(pile_nets, monkeypatch):
    """The seg net + MeanShift + label propagation on the visible objects'
    points, each package with its own net, at the eval's first bandwidth.
    The port's net outputs on the predicter's 20,000 samples are held to
    JAX's jitted net (as JAX's predicter runs it) within the bf16
    tolerances of ``test_torch_nn.py``.  Its labels are held to JAX's
    predicter with the net run op by op, each layer rounded as flax
    declares it (as the port does): equal up to the numbering on >= 99% of
    points, with the same instance count.  XLA's fused CPU forward adds a
    conv's bias without rounding the sum to bf16 where a GroupNorm applies
    its statistics (which it takes from the rounded sum); MeanShift turns
    that into a merged or split instance when a seed lies near the merge
    radius, so against the jitted predicter the labels are held to agree
    at least as well as JAX's two forwards agree with each other (less 1%,
    and >= 99% where they agree that well), with the instance count one
    of those two runs'."""
    cls, out, J, P = pile_nets
    vm = out["seg"] >= 0
    xyz, nrm = out["xyz"][vm], out["normal"][vm]
    assert vm.sum() >= 300
    n = len(xyz)
    ids = np.random.default_rng(0).choice(n, J["seg"].n_pts, replace=n < J["seg"].n_pts)
    x = jnp.asarray(xyz[ids])
    origin = jnp.min(x, axis=0) - 0.01
    oj, bj = (np.asarray(v) for v in jax.jit(J["seg"].model.apply)(
        {"params": J["seg"].params}, x, jnp.asarray(nrm[ids]), origin))
    with torch.no_grad():
        op, bp = (t2n(v) for v in P["seg"].model(torch.as_tensor(xyz[ids]), torch.as_tensor(nrm[ids]),
                                                 torch.as_tensor(np.asarray(origin))))
    d = np.abs(op - oj)
    assert d.max() <= 2e-3 and np.percentile(d, 99) <= 5e-4, (d.max(), np.percentile(d, 99))
    assert ((bp > 0) == (bj > 0)).mean() >= 0.995

    lj, nj = J["seg"].predict(xyz, nrm)
    jit_voxelize = jax.jit(jvoxelnet.voxelize, static_argnums=(3, 4))
    with monkeypatch.context() as m:  # JAX's net op by op (voxelize jitted), the rest as it is
        m.setattr(jax, "jit", lambda f, **kw: f)
        m.setattr(jvoxelnet, "voxelize", jit_voxelize)
        le, ne = J["seg"].predict(xyz, nrm)
    jax_draws(monkeypatch)
    timings = {}
    lp, n_p = P["seg"].predict(xyz, nrm, timings=timings)
    assert lp.dtype == np.int32 and lp.shape == lj.shape
    assert seg_agreement(le, lp) >= 0.99 and n_p == ne
    assert seg_agreement(lj, lp) >= min(0.99, seg_agreement(lj, le)) - 0.01
    assert n_p in (nj, ne) and lp.max() < n_p
    assert timings["seg_net_s"] > 0 and timings["meanshift_s"] > 0
    # a second call draws the same seeds: the same labels
    lp2, _ = P["seg"].predict(xyz, nrm)
    np.testing.assert_array_equal(lp2, lp)


@pytest.mark.parametrize("bandwidth_scale", [1.0, 0.67])
def test_seg_predicter_pipeline_matches_jax(pile_nets, monkeypatch, bandwidth_scale):
    """With JAX's jitted seg-net outputs carried into the port as data (the
    same points, the same origin), the rest of the predicter, MeanShift
    and the label propagation, gives JAX's labels and mode count exactly,
    also at the over-segmenting x0.67 bandwidth."""
    cls, out, J, P = pile_nets
    vm = out["seg"] >= 0
    xyz, nrm = out["xyz"][vm], out["normal"][vm]
    n = len(xyz)
    ids = np.random.default_rng(0).choice(n, J["seg"].n_pts, replace=n < J["seg"].n_pts)
    x = jnp.asarray(xyz[ids])
    origin = jnp.min(x, axis=0) - 0.01
    off, obj = jax.jit(J["seg"].model.apply)({"params": J["seg"].params}, x,
                                             jnp.asarray(nrm[ids]), origin)

    def net_outputs(xyz_p, nrm_p, origin_p):
        np.testing.assert_array_equal(t2n(xyz_p), xyz[ids])
        np.testing.assert_array_equal(t2n(origin_p), np.asarray(origin))
        return torch.as_tensor(np.array(off)), torch.as_tensor(np.array(obj))

    monkeypatch.setattr(P["seg"].model, "forward", net_outputs)
    jax_draws(monkeypatch)
    lp, n_p = P["seg"].predict(xyz, nrm, bandwidth_scale=bandwidth_scale)
    # JAX's predicter on the same outputs, without running its net again
    monkeypatch.setattr(jax, "jit", lambda f, **kw: lambda *a: (off, obj))
    lj, nj = J["seg"].predict(xyz, nrm, bandwidth_scale=bandwidth_scale)
    assert n_p == nj
    np.testing.assert_array_equal(lp, lj)


def test_nunocs_predicter_matches_jax(pile_nets, monkeypatch):
    """The NUNOCS net and the RANSAC 9D fit on the largest body's points:
    the bins equal, valid and ratio equal, the pose within 1e-5."""
    cls, out, J, P = pile_nets
    body = np.bincount(out["seg"][out["seg"] >= 0]).argmax()
    m = out["seg"] == body
    rj = J["nocs"].predict(out["xyz"][m], out["normal"][m])
    jax_draws(monkeypatch)
    rp = P["nocs"].predict(out["xyz"][m], out["normal"][m])
    np.testing.assert_array_equal(rp["cloud_ids"], rj["cloud_ids"])
    np.testing.assert_array_equal(rp["nocs_cloud"], rj["nocs_cloud"])
    assert rp["valid"] == rj["valid"] and rp["ratio"] == rj["ratio"] > 0
    np.testing.assert_allclose(rp["nocs_pose"], rj["nocs_pose"], atol=1e-5)
    np.testing.assert_array_equal(rp["inliers"], rj["inliers"])


def test_grasp_predicter_matches_jax(pile_nets):
    """The grasp net's score distributions of 7 grasps on the pile cloud
    within 1e-5, JAX in padded batches of 4 and the port in unpadded
    batches of 3; the expected quality likewise."""
    cls, out, J, P = pile_nets
    vm = out["seg"] >= 0
    xyz, nrm = out["xyz"][vm], out["normal"][vm]
    rng = np.random.default_rng(1)
    g = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    q = rng.normal(size=(7, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from catgrasp_tpu_torch.core import transforms as tf
    g[:, :3, :3] = t2n(tf.quat_to_matrix(torch.as_tensor(q, dtype=torch.float32)))
    g[:, :3, 3] = xyz[rng.choice(len(xyz), 7)]
    J["grasp"].batch, P["grasp"].batch = 4, 3
    lj, cj, dj = J["grasp"].predict_batch(xyz, nrm, g)
    lp, cp, dp = P["grasp"].predict_batch(xyz, nrm, g)
    assert dp.shape == dj.shape == (7, 10)
    np.testing.assert_allclose(dp, dj, atol=1e-5)
    np.testing.assert_allclose(P["grasp"].expected_quality(dp),
                               J["grasp"].expected_quality(dj), atol=1e-5)
    np.testing.assert_allclose(cp, cj, atol=1e-5)


def test_load_predicters_roles(tmp_path, capsys):
    """The configs' widths and the calibrated bandwidth, as JAX's
    ``load_predicters`` builds them; a role without its directory is
    skipped; ``best_train`` then ``last`` stand in for ``best_val``."""
    P = load_predicters("artifacts_tracked/screw", "screw", device="cpu")
    J = jload_predicters("artifacts_tracked/screw", "screw")
    assert sorted(P) == sorted(J) == ["grasp", "nocs", "seg"]
    assert (P["nocs"].n_pts, P["nocs"].n_bins, P["grasp"].n_pts, P["grasp"].batch) == \
        (J["nocs"].n_pts, J["nocs"].n_bins, J["grasp"].n_pts, J["grasp"].batch)
    assert (P["seg"].n_pts, P["seg"].bandwidth, P["seg"].class_name) == \
        (J["seg"].n_pts, J["seg"].bandwidth, J["seg"].class_name)
    assert (P["seg"].model.voxel_size, P["seg"].model.grid_dims) == \
        (J["seg"].model.voxel_size, J["seg"].model.grid_dims)
    assert "calibrated MeanShift bandwidth 0.0123" in capsys.readouterr().out
    (tmp_path / "grasp").mkdir()
    (tmp_path / "grasp" / "last.ckpt").write_bytes(
        open("artifacts_tracked/screw/grasp/best_val.ckpt", "rb").read())
    P = load_predicters(str(tmp_path), "screw", device="cpu")
    assert sorted(P) == ["grasp"] and P["grasp"].model.Dense_0.out_features == 10
    with pytest.raises(FileNotFoundError):
        artifacts._ckpt(str(tmp_path))
