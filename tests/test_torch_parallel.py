"""The port's ``parallel/`` and the trainer's mesh step against the JAX
package, on meshes of CPU devices (``[torch.device("cpu")] * 8``, the
counterpart of the 8 host devices JAX's tests force): JAX's four tests of
``tests/test_parallel.py`` on the same numpy inputs, then the mesh train
step of each net against JAX's sharded step and against its own
one-device step, and the errors the mesh raises."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from catgrasp_tpu.geom import csg as jcsg
from catgrasp_tpu.geom import primitives as jprim
from catgrasp_tpu.nn.pointnet import PointNetSeg as JPointNetSeg
from catgrasp_tpu.parallel import mesh as jmesh
from catgrasp_tpu.parallel import rollout as jrollout
from catgrasp_tpu.pipelines import train_nunocs as jtrain_nunocs
from catgrasp_tpu.sim import engine as jengine
from catgrasp_tpu.sim import env_pile as jpile
from catgrasp_tpu.sim.types import build_shape_lib as jbuild
from catgrasp_tpu.train import trainer as JT
from catgrasp_tpu_torch.parallel import mesh as pmesh
from catgrasp_tpu_torch.parallel import rollout as prollout
from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs, train_seg
from catgrasp_tpu_torch.sim import engine as pengine
from catgrasp_tpu_torch.train import trainer as T
from test_torch_common import CPU, port_env, port_lib, port_params, port_state, t2n
from test_torch_trainer import CFG, _assert_params_close, _clouds, _cos, _port_state, _seg_case

torch.set_num_threads(2)

CPUS = [CPU] * 8


@pytest.fixture(scope="module")
def piles():
    """JAX's reset of 8 nut piles of 2 bodies (``tests/test_parallel.py``),
    its ``sharded_rollout`` of 10 steps on ``make_mesh(8)``, and the same
    inputs in the port."""
    lib = jbuild([jprim.make_instance("nut", "train", 0)],
                 [jcsg.make_csg_instance("nut", "train", 0)], n_surf=16)
    cfg = jpile.PileConfig(max_bodies=2)
    env = jengine.StaticEnv.open_bin(cfg.bin_inner)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    states, params = jax.vmap(lambda k: jpile.reset(k, lib, cfg))(keys)
    out = jrollout.sharded_rollout(jmesh.make_mesh(8), states, params, lib, env, n_steps=10)
    return (port_state(states), port_params(params), port_lib(lib), port_env(env),
            np.asarray(out.pos))


def test_sharded_rollout_matches_whole_batch_and_jax(piles):
    """Each of the 8 shards steps its scene alone; the gathered batch equals
    ``rollout_batch`` on the whole batch within 1e-6 m (found: bit-equal)
    and JAX's sharded rollout within the engine's 1e-3 m
    (``tests/test_torch_sim.py``)."""
    states, params, lib, env, jpos = piles
    mesh = pmesh.make_mesh(devices=CPUS)
    assert [len(s.pos) for s in pmesh.shard_batch(mesh, states)] == [1] * 8
    out = prollout.sharded_rollout(mesh, states, params, lib, env, n_steps=10)
    ref = pengine.rollout_batch(states, params, lib, env, 10)
    np.testing.assert_allclose(t2n(out.pos), t2n(ref.pos), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t2n(out.active), t2n(ref.active))
    print("sharded rollout bit-equal to the whole batch:",
          all(torch.equal(getattr(out, k), getattr(ref, k))
              for k in ("pos", "quat", "linvel", "angvel")))
    np.testing.assert_allclose(t2n(out.pos), jpos, rtol=0, atol=1e-3)


def test_sharded_map():
    mesh = pmesh.make_mesh(8, devices=CPUS * 2)
    x = np.arange(16.0, dtype=np.float32).reshape(16, 1)
    y = prollout.sharded_map(mesh, lambda v: v * 2 + 1, torch.from_numpy(x))
    jy = jrollout.sharded_map(jmesh.make_mesh(8), lambda v: v * 2 + 1, jnp.asarray(x))
    np.testing.assert_array_equal(t2n(y), np.asarray(jy))
    np.testing.assert_array_equal(t2n(y), x * 2 + 1)


def test_multislice_mesh_rollout_parity(piles):
    """2 slices x (dp=2, mp=2): the batch splits over ("slice", "dp"), 4
    shards on the first device of each mp pair."""
    states, params, lib, env, _ = piles
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = pmesh.make_multislice_mesh(2, mp=2, devices=devs)
    assert mesh.axis_names == jmesh.make_multislice_mesh(2, mp=2).axis_names
    assert mesh.shape == {"slice": 2, "dp": 2, "mp": 2}
    assert [d.index for d in pmesh.dp_sharding(mesh)] == [0, 2, 4, 6]
    assert [d.index for d in pmesh.replicated(mesh)] == list(range(8))
    out = prollout.sharded_rollout(mesh, states, params, lib, env, n_steps=10)
    ref = pengine.rollout_batch(states, params, lib, env, 10)
    np.testing.assert_allclose(t2n(out.pos), t2n(ref.pos), rtol=0, atol=1e-6)


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w))

    def forward(self, x):
        return x @ self.w


def _square_loss(model, batch, train):
    return torch.mean(model(batch["x"]) ** 2), {}


def test_multislice_gradient_reduction():
    """The gradient of ``mean((x @ w) ** 2)`` through the mesh step on a
    (slice=2, dp=4) mesh equals the one-device gradient and JAX's sharded
    one."""
    w = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
    x = np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32)
    cfg = {"optimizer_type": "sgd", "start_lr": 0.0, "grad_clip_norm": 1e9}
    grads = {}
    for name, mesh in (("one", None), ("mesh", pmesh.make_multislice_mesh(2, devices=CPUS))):
        state = T.TrainState(model=_Linear(w), tx=None)
        state.tx = T.make_optimizer(state.model, cfg, 1)
        T.make_train_step(_square_loss, mesh)(state, {"x": torch.from_numpy(x)})
        grads[name] = t2n(state.model.w.grad)
    np.testing.assert_allclose(grads["mesh"], grads["one"], rtol=1e-6)

    jm = jmesh.make_multislice_mesh(2, mp=1)
    gfn = jax.jit(jax.grad(lambda w, x: jnp.mean((x @ w) ** 2)),
                  in_shardings=(NamedSharding(jm, P()), jmesh.dp_sharding(jm)),
                  out_shardings=NamedSharding(jm, P()))
    np.testing.assert_allclose(grads["mesh"], np.asarray(gfn(jnp.asarray(w), jnp.asarray(x))),
                               rtol=1e-6)


def test_nunocs_mesh_step_matches_jax_mesh_step():
    """One step of the NUNOCS net (batch 8, 64 points) on an 8-device mesh
    against JAX's ``make_train_step(loss, mesh=make_mesh(8))`` from the
    same parameters: the loss, and every leaf within 1e-4 of its norm."""
    rng = np.random.default_rng(0)
    cfg = dict(CFG, optimizer_type="sgd", batch_size=8)
    batch = {"x": _clouds(rng, b=8), "nocs": rng.uniform(0.05, 0.95, (8, 64, 3))
             .astype(np.float32)}
    jmodel, jloss = JPointNetSeg(n_out=300), jtrain_nunocs.build(cfg, "nut")[1]
    model, loss = train_nunocs.build(cfg, "nut")
    jstate = JT.create_state(jmodel, cfg, jnp.asarray(batch["x"]), steps_per_epoch=3)
    state = _port_state(model, jstate, cfg, 3)
    jstep = JT.make_train_step(jloss, mesh=jmesh.make_mesh(8), donate=False)
    jstate, lj, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    state, lp, _ = T.make_train_step(loss, pmesh.make_mesh(devices=CPUS))(
        state, T.to_device(batch, "cpu"))
    assert abs(float(lp) - float(lj)) <= 1e-4 * abs(float(lj))
    _assert_params_close(model, jstate.params)


def _grads(model):
    return {k: t2n(p.grad).ravel() for k, p in model.named_parameters()}


@pytest.mark.parametrize("net", ["grasp", "seg"])
def test_mesh_step_equals_one_device_step(net):
    """The grasp net (dropout off: the mesh draws a mask per shard) on 4
    shards and the seg net on 2, each from the parameters of the
    one-device step's model: the same loss, gradients and parameters (the
    grasp net's gradients within 1e-5 of each leaf's norm; the seg net's,
    in bf16, at cosine >= 0.999, as held on the card)."""
    if net == "grasp":
        cfg = dict(CFG, classes=list(np.linspace(0, 1, 11)), batch_size=8)
        model, loss = train_grasp.build(cfg)
        model.dropout = 0.0
        rng = np.random.default_rng(2)
        batch = {"x": _clouds(rng, b=8), "label": rng.integers(0, 10, 8).astype(np.int32)}
        mesh = pmesh.make_mesh(devices=CPUS[:4])
    else:
        cfg = dict(CFG, voxel_size=0.01, grid_dims=[24, 24, 12], batch_size=2)
        model, loss = train_seg.build(cfg)
        batch = _seg_case()
        mesh = pmesh.make_mesh(devices=CPUS[:2])
    one = T.create_state(model, cfg, 3, device="cpu")
    sharded = T.TrainState(model=copy.deepcopy(model), tx=None)
    sharded.tx = T.make_optimizer(sharded.model, cfg, 3)
    _, l1, _ = T.make_train_step(loss)(one, T.to_device(batch, "cpu"))
    _, lm, _ = T.make_train_step(loss, mesh)(sharded, T.to_device(batch, "cpu"))
    assert abs(float(lm) - float(l1)) <= 1e-5 * abs(float(l1))
    g1, gm = _grads(one.model), _grads(sharded.model)
    for k, r in g1.items():
        if net == "grasp":
            assert np.abs(gm[k] - r).max() <= 1e-5 * max(np.linalg.norm(r), 1e-6), k
        else:
            assert _cos(gm[k], r) >= 0.999, k
    if net == "grasp":
        for a, b in zip(one.model.parameters(), sharded.model.parameters()):
            assert float((a - b).detach().abs().max()) <= 1e-4 * float(a.detach().norm())


def test_mesh_trainer_checkpoint_resumes_on_one_device_and_in_jax(tmp_path):
    """``Trainer(mesh=...)``'s ``last.ckpt`` loads into a one-device state
    of the port and into JAX's ``load_checkpoint`` with its parameters."""
    from catgrasp_tpu.nn.pointnet import PointNetCls as JPointNetCls
    from catgrasp_tpu_torch.nn.pointnet import PointNetCls
    rng = np.random.default_rng(3)
    batches = [{"x": _clouds(rng, b=4), "y": rng.integers(0, 10, 4)} for _ in range(2)]

    def loss(model, batch, train):
        logits, _ = model(batch["x"], train=train)
        return torch.nn.functional.cross_entropy(logits, batch["y"].long()), {}

    cfg = dict(CFG, n_epochs=1)
    model = PointNetCls(10, dropout=0.0)
    state = T.create_state(model, cfg, 2, device="cpu")
    tr = T.Trainer(model=model, cfg=cfg, loss_fn=loss, train_data=lambda: iter(batches),
                   mesh=pmesh.make_mesh(devices=CPUS[:2]), ckpt_dir=str(tmp_path))
    state = tr.fit(state, verbose=False)
    assert state.step == 2
    fresh, epoch = T.load_checkpoint(str(tmp_path / "last.ckpt"),
                                     T.create_state(PointNetCls(10, dropout=0.0), cfg, 2,
                                                    device="cpu"))
    assert (fresh.step, epoch, fresh.tx.count) == (2, 0, 2)
    for a, b in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    jstate = JT.create_state(JPointNetCls(n_out=10, dropout=0.0), cfg,
                             jnp.asarray(batches[0]["x"]), steps_per_epoch=2)
    jstate, jepoch = JT.load_checkpoint(str(tmp_path / "last.ckpt"), jstate)
    assert int(jstate.step) == 2 and jepoch == 0
    _assert_params_close(state.model, jstate.params, rel=0.0)


def test_a_batch_the_mesh_does_not_divide_raises(piles):
    states, params, lib, env, _ = piles
    mesh = pmesh.make_mesh(devices=CPUS[:3])
    with pytest.raises(ValueError, match="does not split into 3"):
        prollout.sharded_rollout(mesh, states, params, lib, env, n_steps=1)
    state = T.TrainState(model=_Linear(np.eye(2, dtype=np.float32)), tx=None)
    state.tx = T.make_optimizer(state.model, {}, 1)
    with pytest.raises(ValueError, match="does not split into 3"):
        T.make_train_step(_square_loss, mesh)(state, {"x": torch.zeros(8, 2)})


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_multislice_mesh(1)
