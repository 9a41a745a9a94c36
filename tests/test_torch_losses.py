"""The port's training arithmetic against the JAX package's on the same
numpy inputs: every loss with its gradient against ``jax.value_and_grad``
(loss within 1e-5 relative, each gradient within 1e-4 of its norm), the
learning-rate schedule against optax's at every step, the global-norm clip
against ``optax.clip_by_global_norm``, dropout's keep rate and scaling, and
the flax-like initialiser against ``model.init``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from catgrasp_tpu.core.symmetry import get_symmetry_tfs
from catgrasp_tpu.nn import losses as jlosses
from catgrasp_tpu.nn.pointnet import PointNetCls as JPointNetCls
from catgrasp_tpu.nn.pointnet import feature_transform_regularizer as jreg
from catgrasp_tpu.nn.voxelnet import SegNet as JSegNet
from catgrasp_tpu.train import trainer as jtrainer
from catgrasp_tpu_torch import convert
from catgrasp_tpu_torch.nn import losses
from catgrasp_tpu_torch.nn.init import init_like_flax
from catgrasp_tpu_torch.nn.pointnet import PointNetCls, feature_transform_regularizer
from catgrasp_tpu_torch.nn.voxelnet import SegNet
from catgrasp_tpu_torch.train import trainer

torch.set_num_threads(2)


def _check(jfn, pfn, args, argnums):
    """Loss within 1e-5 relative; each gradient within 1e-4 of its norm."""
    lj, gj = jax.value_and_grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(args)]
    lp = pfn(*targs)
    lp.backward()
    assert abs(float(lp) - float(lj)) <= 1e-5 * max(abs(float(lj)), 1e-6)
    for i, g in zip(argnums, gj):
        g = np.asarray(g)
        err = np.abs(targs[i].grad.numpy() - g).max()
        assert err <= 1e-4 * np.linalg.norm(g), (i, err, np.linalg.norm(g))


@pytest.mark.parametrize("cls", ["nut", "screw", "hnm"])
def test_nocs_min_symmetry_ce(cls):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 96, 300)).astype(np.float32)
    target = rng.uniform(0.02, 0.98, (3, 96, 3)).astype(np.float32)
    sym = get_symmetry_tfs(cls).astype(np.float32)
    _check(lambda lg, t: jlosses.nocs_min_symmetry_ce(lg, t, jnp.asarray(sym)),
           lambda lg, t: losses.nocs_min_symmetry_ce(lg, t, torch.as_tensor(sym)),
           [logits, target], (0,))


def test_grasp_quality_losses():
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(32, 10))).astype(np.float32)
    bins = rng.integers(0, 10, 32).astype(np.int32)
    _check(lambda lg: jlosses.grasp_quality_ce(lg, jnp.asarray(bins)),
           lambda lg: losses.grasp_quality_ce(lg, torch.as_tensor(bins)), [logits], (0,))
    _check(lambda lg: jlosses.grasp_quality_ordinal(lg, jnp.asarray(bins)),
           lambda lg: losses.grasp_quality_ordinal(lg, torch.as_tensor(bins)), [logits], (0,))


def test_offset_loss_per_scene_and_batched():
    rng = np.random.default_rng(2)
    pred = (0.02 * rng.normal(size=(3, 200, 3))).astype(np.float32)
    gt = (0.02 * rng.normal(size=(3, 200, 3))).astype(np.float32)
    valid = rng.uniform(size=(3, 200)) > 0.4
    for b in range(3):
        _check(lambda p, g: jlosses.offset_loss(p, g, jnp.asarray(valid[b])),
               lambda p, g: losses.offset_loss(p, g, torch.as_tensor(valid[b])),
               [pred[b], gt[b]], (0,))
    batched = losses.offset_loss(torch.as_tensor(pred), torch.as_tensor(gt),
                                 torch.as_tensor(valid)).numpy()
    per = [float(jlosses.offset_loss(pred[b], gt[b], valid[b])) for b in range(3)]
    np.testing.assert_allclose(batched, per, rtol=1e-5)


def test_feature_transform_regularizer():
    rng = np.random.default_rng(3)
    a = (np.eye(64) + 0.1 * rng.normal(size=(4, 64, 64))).astype(np.float32)
    _check(jreg, feature_transform_regularizer, [a], (0,))


@pytest.mark.parametrize("warmup", [0, 5])
@pytest.mark.parametrize("opt_cfg", [dict(start_lr=0.01, batch_size=240, milestones=[1, 2]),
                                     dict(start_lr=0.003, batch_size=34, milestones=[2])])
def test_schedule_matches_optax(opt_cfg, warmup):
    """``multistep_lr`` at every step of 3 epochs of 7 steps (and past)
    against the JAX trainer's optax schedule, float32 for float32."""
    spe = 7
    sj = jtrainer.multistep_lr(opt_cfg["start_lr"], opt_cfg["batch_size"],
                               opt_cfg["milestones"], spe, warmup_steps=warmup)
    sp = trainer.multistep_lr(opt_cfg["start_lr"], opt_cfg["batch_size"],
                              opt_cfg["milestones"], spe, warmup_steps=warmup)
    vals_j = np.array([float(sj(jnp.int32(c))) for c in range(3 * spe + warmup + 3)])
    vals_p = np.array([sp(c) for c in range(3 * spe + warmup + 3)])
    np.testing.assert_array_equal(vals_p.astype(np.float32), vals_j.astype(np.float32))
    assert len(set(vals_p.tolist())) >= 2 + (warmup > 0)


@pytest.mark.parametrize("scale", [0.3, 5.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [(scale * rng.normal(size=s) / 10).astype(np.float32) for s in ((7, 5), (5,), (3, 3))]
    clip = optax.clip_by_global_norm(1.0)
    out_j, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    gp = [torch.tensor(g) for g in grads]
    norm = trainer.clip_by_global_norm_(gp, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g * g).sum() for g in grads)),
                               rtol=1e-6)
    for a, b in zip(gp, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7, atol=1e-9)


def test_dropout_keep_rate_and_scaling():
    """``PointNetCls(train=True)``: the 512-wide features after the first
    head layer kept with probability 1 - p and scaled by 1 / (1 - p), as
    flax's ``Dropout``; ``train=False`` (the default) is deterministic."""
    torch.manual_seed(0)
    net = PointNetCls(10, dropout=0.4)
    seen = {}
    net.MLPStack_0.register_forward_hook(lambda m, i, o: seen.__setitem__("h", o))
    net.MLPStack_1.register_forward_pre_hook(lambda m, i: seen.__setitem__("d", i[0]))
    x = torch.randn(64, 32, 6)
    with torch.no_grad():
        net(x, train=True)
        h, d = seen["h"], seen["d"]
        live = h > 0  # after the ReLU
        kept = (d != 0) & live
        rate = float(kept.sum()) / float(live.sum())
        assert abs(rate - 0.6) < 0.02, rate
        torch.testing.assert_close(d[kept], h[kept] / 0.6, rtol=1e-6, atol=0)
        a, b = net(x)[0], net(x)[0]
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert torch.equal(seen["d"], seen["h"])


@pytest.mark.parametrize("which", ["pointnet", "segnet"])
def test_init_draws_as_flax(which):
    """``init_like_flax`` against flax's ``model.init`` of the same net:
    the same parameter names and shapes, zero biases, unit GroupNorm
    scales, the STNs' last Dense all zeros, and each kernel's standard
    deviation within 10% of flax's and inside its 2-sigma truncation."""
    if which == "pointnet":
        jnet, net = JPointNetCls(n_out=10), PointNetCls(10)
        variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 6)))
    else:
        jnet, net = JSegNet(voxel_size=0.01, grid_dims=(8, 8, 8)), SegNet(voxel_size=0.01,
                                                                          grid_dims=(8, 8, 8))
        variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((16, 3)), jnp.ones((16, 3)),
                              jnp.zeros(3))
    ref = convert.flax_state_dict(jax.tree.map(np.asarray, dict(variables["params"])))
    init_like_flax(net, torch.Generator().manual_seed(0))
    mine = net.state_dict()
    assert sorted(mine) == sorted(ref)
    for k, r in ref.items():
        m = mine[k]
        assert m.shape == r.shape, k
        r = r.numpy()
        if not k.endswith("weight") or not r.std():
            np.testing.assert_array_equal(m.numpy(), r, err_msg=k)  # zeros, ones
            continue
        if "GroupNorm" in k:
            continue
        fan_in = np.prod(r.shape[1:]) if "ConvTranspose" not in k else r.shape[0] * 8
        bound = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(m.numpy()).max() <= bound * (1 + 1e-6), k
        if r.size >= 1000:
            assert abs(m.numpy().std() / r.std() - 1) < 0.1, k
