"""The port's trainer (``train/trainer.py``), the nets' training mode and
the three training pipelines against the JAX package: training steps from
the same parameters against JAX's ``make_train_step`` (parameters within
1e-4 of each leaf's norm after 5 steps), the seg net's gradients (equal in
f32; in bf16 held through the f32 ones), checkpoints that
resume in the other package with the same next step, the four behaviours
of ``tests/test_trainer.py``, the grasp trainer's ``prior.json`` and the
entry points on a tiny packed split on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgrasp_tpu.nn.pointnet import PointNetCls as JPointNetCls
from catgrasp_tpu.nn.pointnet import PointNetSeg as JPointNetSeg
from catgrasp_tpu.pipelines import train_grasp as jtrain_grasp
from catgrasp_tpu.pipelines import train_nunocs as jtrain_nunocs
from catgrasp_tpu.pipelines import train_seg as jtrain_seg
from catgrasp_tpu.train import trainer as JT
from catgrasp_tpu_torch import convert
from catgrasp_tpu_torch.data import packed
from catgrasp_tpu_torch.nn.pointnet import PointNetCls
from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
from catgrasp_tpu_torch.pipelines import pack_training_data as ptd
from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs, train_seg
from catgrasp_tpu_torch.predict import ckpt
from catgrasp_tpu_torch.predict.artifacts import load_predicters
from catgrasp_tpu_torch.train import trainer as T
from test_torch_common import small_scene_cfg

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_params_close(model, jparams, rel=1e-4, stn_rel=None):
    """Each leaf within ``rel`` of its norm; the spatial transformers'
    hidden layers within ``stn_rel`` where given (see
    ``test_training_steps_match_jax``)."""
    mine = _flat(convert.flax_params(model.state_dict()))
    ref = _flat(jax.tree.map(np.asarray, dict(jparams)))
    assert sorted(mine) == sorted(ref)
    for k, r in ref.items():
        err = np.abs(mine[k] - r).max()
        tol = stn_rel if stn_rel and "/STN_" in k and "/MLPStack_" in k else rel
        assert err <= tol * max(np.linalg.norm(r), 1e-6), (k, err, np.linalg.norm(r))


def _clouds(rng, b=4, n=64, n_out=None):
    x = rng.normal(size=(b, n, 6)).astype(np.float32)
    x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    return x


def _port_state(model, jstate, cfg, spe):
    model.load_state_dict(convert.flax_state_dict(jax.tree.map(np.asarray,
                                                               dict(jstate.params))))
    return T.TrainState(model=model, tx=T.make_optimizer(model, cfg, spe))


CFG = {"start_lr": 0.01, "batch_size": 4, "lr_milestones": [1], "weight_decay": 1e-4,
       "warmup_steps": 2, "grad_clip_norm": 1.0, "random_seed": 0}


@pytest.mark.parametrize("net", ["nunocs", "grasp"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_training_steps_match_jax(net, opt):
    """5 steps of ``PointNetSeg`` under the NUNOCS loss and of
    ``PointNetCls(dropout=0)`` under the grasp loss, from the same
    parameters, through the warmup and a milestone (3 steps an epoch):
    every leaf within 1e-4 of its norm, but under Adam the spatial
    transformers' hidden layers within 1e-3.  Found: their gradients are
    exactly 0 at the first step (the transformers' last Dense starts at 0)
    and ~1e-9 after it, near Adam's eps, where its step g / (sqrt(v) + eps)
    passes the two packages' f32 rounding of g through almost unscaled
    (up to 4.2e-4 of a leaf's norm there, under 3e-5 everywhere else; SGD
    holds every leaf within 1.5e-5)."""
    rng = np.random.default_rng(0)
    cfg = dict(CFG, optimizer_type=opt)
    if net == "nunocs":
        jmodel, jloss = JPointNetSeg(n_out=300), jtrain_nunocs.build(cfg, "nut")[1]
        model, loss = train_nunocs.build(cfg, "nut")
        batches = [{"x": _clouds(rng), "nocs": rng.uniform(0.05, 0.95, (4, 64, 3))
                    .astype(np.float32)} for _ in range(5)]
    else:
        jmodel, jloss = JPointNetCls(n_out=10, dropout=0.0), jtrain_grasp.build(
            dict(cfg, classes=list(np.linspace(0, 1, 11))))[1]
        model, loss = train_grasp.build(dict(cfg, classes=list(np.linspace(0, 1, 11))))
        model.dropout = 0.0
        batches = [{"x": _clouds(rng), "label": rng.integers(0, 10, 4).astype(np.int32)}
                   for _ in range(5)]
    jstate = JT.create_state(jmodel, cfg, jnp.asarray(batches[0]["x"]), steps_per_epoch=3)
    state = _port_state(model, jstate, cfg, 3)
    jstep, step = JT.make_train_step(jloss, donate=False), T.make_train_step(loss)
    for b in batches:
        jstate, lj, _ = jstep(jstate, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(0))
        state, lp, _ = step(state, T.to_device(b, "cpu"))
        assert abs(float(lp) - float(lj)) <= 1e-4 * abs(float(lj))
    assert state.step == int(jstate.step) == 5 and state.tx.count == 5
    _assert_params_close(model, jstate.params, stn_rel=1e-3 if opt == "adam" else None)


def _seg_case():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(0.0, 0.2, (2, 600, 3)).astype(np.float32)
    xyz[..., 2] *= 0.5
    nrm = rng.normal(size=(2, 600, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    inst = rng.integers(-2, 4, (2, 600)).astype(np.int32)
    centers = rng.uniform(0.0, 0.2, (2, 4, 3)).astype(np.float32)
    off = np.where((inst >= 0)[..., None], np.take_along_axis(
        centers, np.maximum(inst, 0)[..., None].repeat(3, -1), 1) - xyz, 0.0).astype(np.float32)
    return {"xyz": xyz, "normal": nrm, "instance_id": inst, "offsets": off}


def _seg_grads(batch, compute, monkeypatch):
    """(JAX loss, JAX grads, port loss, port grads) of the seg net at a
    24x24x12 grid of 1 cm voxels from one init, its convs in ``compute``
    ("bf16", as trained, or "f32")."""
    from catgrasp_tpu.nn import voxelnet as jvoxelnet
    from catgrasp_tpu_torch.nn import voxelnet
    cfg = {"voxel_size": 0.01, "grid_dims": [24, 24, 12]}
    _, jloss = jtrain_seg.build(cfg)
    jmodel = jvoxelnet.SegNet(voxel_size=0.01, grid_dims=(24, 24, 12),
                              compute_dtype=jnp.bfloat16 if compute == "bf16" else jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(batch["xyz"][0]),
                         jnp.asarray(batch["normal"][0]), jnp.zeros(3))["params"]
    (lj, _), gj = jax.value_and_grad(jloss, has_aux=True)(
        params, jmodel.apply, jax.tree.map(jnp.asarray, batch), None)
    monkeypatch.setattr(voxelnet, "COMPUTE_DTYPE",
                        torch.bfloat16 if compute == "bf16" else torch.float32)
    model, loss = train_seg.build(cfg)
    model.load_state_dict(convert.flax_state_dict(jax.tree.map(np.asarray, dict(params))))
    lp, _ = loss(model, T.to_device(batch, "cpu"), True)
    lp.backward()
    ref = convert.flax_state_dict(jax.tree.map(np.asarray, dict(gj)))
    return (float(lj), {k: v.numpy().ravel() for k, v in ref.items()}, float(lp.detach()),
            {k: p.grad.numpy().ravel() for k, p in model.named_parameters()})


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_seg_net_gradients_match_jax(monkeypatch):
    """The seg net's loss and gradients, 2 scenes of 600 points at a
    24x24x12 grid (each scene voxelized with its own origin: the JAX
    trainer ``vmap``s the scenes, the port voxelizes them with a scene
    index).  With the convs in f32 both packages give the same gradients:
    every leaf at cosine >= 0.9999 and norm within 1e-3, the loss within
    1e-5.  In bf16, as the net trains, the loss is within 1e-2; but bf16
    itself moves each package's gradients off the f32 ones (cosine 0.95-0.99
    for the U-Net's leaves in both), so the 0.99 cosine between the two bf16
    gradients is not reached on every leaf.  Found: kernels and GroupNorm
    parameters 0.98-0.9999 apart, the conv biases down to 0.77, where
    JAX's bias gradients sit furthest from f32 (norm up to +36%; the port's
    within 6%), its bf16 cotangent summed over the grid.  So the bf16
    gradients are held to the f32 ones: each leaf of the port's at most
    0.02 of cosine further from them than JAX's own, its norm within 12%,
    and the kernels and GroupNorm parameters at cosine >= 0.98 to JAX's."""
    batch = _seg_case()
    lj, gj, lp, gp = _seg_grads(batch, "f32", monkeypatch)
    assert abs(lp - lj) <= 1e-5 * abs(lj)
    for k, r in gj.items():
        assert _cos(gp[k], r) >= 0.9999, k
        assert abs(np.linalg.norm(gp[k]) / np.linalg.norm(r) - 1) <= 1e-3, k
    lj16, gj16, lp16, gp16 = _seg_grads(batch, "bf16", monkeypatch)
    assert abs(lp16 - lj16) <= 1e-2 * abs(lj16)
    for k, f32 in gj.items():
        assert _cos(gp16[k], f32) >= _cos(gj16[k], f32) - 0.02, k
        assert abs(np.linalg.norm(gp16[k]) / np.linalg.norm(f32) - 1) <= 0.12, k
        if not (k.endswith("bias") and ".Conv" in k):
            assert _cos(gp16[k], gj16[k]) >= 0.98, k


def test_batched_seg_net_equals_each_scene():
    torch.manual_seed(0)
    model, _ = train_seg.build({"voxel_size": 0.01, "grid_dims": [16, 16, 8]})
    from catgrasp_tpu_torch.nn.init import init_like_flax
    init_like_flax(model, torch.Generator().manual_seed(0))
    xyz = torch.rand(3, 300, 3) * 0.15
    nrm = torch.randn(3, 300, 3)
    origin = xyz.amin(dim=1) - 0.01
    with torch.no_grad():
        off, obj = model(xyz, nrm, origin)
        for b in range(3):
            o1, j1 = model(xyz[b], nrm[b], origin[b])
            torch.testing.assert_close(off[b], o1, rtol=0, atol=2e-6)
            torch.testing.assert_close(obj[b], j1, rtol=0, atol=2e-5)


# ---- the four behaviours of tests/test_trainer.py -------------------------


def _data(n_batches=3, b=4, n=64):
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(b, n, 6)).astype(np.float32),
                "y": rng.integers(0, 10, b)} for _ in range(n_batches)]
    return lambda: iter(batches)


def _loss(model, batch, train):
    logits, _ = model(batch["x"], train=train)
    return torch.nn.functional.cross_entropy(logits, batch["y"].long()), {}


def _make(tmp_path, **cfg_kw):
    model = PointNetCls(10)
    cfg = {"n_epochs": 2, "start_lr": 0.01, "batch_size": 4, "lr_milestones": [],
           "random_seed": 0, **cfg_kw}
    state = T.create_state(model, cfg, device="cpu")
    tr = T.Trainer(model=model, cfg=cfg, loss_fn=_loss, train_data=_data(),
                   val_data=_data(2), ckpt_dir=str(tmp_path))
    return tr, state


def _events(tmp_path):
    return [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]


def test_fit_improves_and_checkpoints(tmp_path):
    tr, state = _make(tmp_path)
    s0 = tr.evaluate(state)
    state = tr.fit(state, verbose=False)
    assert tr.evaluate(state) < s0
    for name in ("best_train.ckpt", "best_val.ckpt", "last.ckpt"):
        assert os.path.exists(tmp_path / name)
    lines = _events(tmp_path)
    assert sum(1 for e in lines if e["kind"] == "epoch") == 2
    assert all("train_loss" in e and "val_loss" in e for e in lines if e["kind"] == "epoch")
    assert any(e["kind"] == "timing" and {"input.next", "train.step"} <= set(e) for e in lines)


def test_resume_roundtrip(tmp_path):
    tr, state = _make(tmp_path)
    state = tr.fit(state, verbose=False)
    _, fresh = _make(tmp_path)
    restored, epoch = T.load_checkpoint(str(tmp_path / "best_train.ckpt"), fresh)
    assert restored.step > 0 and epoch >= 0 and restored.tx.count == restored.step
    assert abs(tr.evaluate(state) - tr.evaluate(restored)) < 1e-6
    out = tr.fit(restored, n_epochs=1, verbose=False)
    assert out.step > restored.step - 6 and out.tx.count > 0


def test_max_seconds_bound_checkpoints_partial_epoch(tmp_path):
    tr, state = _make(tmp_path)
    tr.train_data = _data(n_batches=8)
    out = tr.fit(state, n_epochs=5, log_every=2, verbose=False, max_seconds=0.0)
    assert os.path.exists(tmp_path / "best_train.ckpt")
    assert os.path.exists(tmp_path / "last.ckpt")
    assert len([e for e in _events(tmp_path) if e["kind"] == "epoch"]) == 1
    assert out.step == 2


def test_val_plateau_reverts_to_best_and_decays_lr(tmp_path):
    tr, state = _make(tmp_path, n_epochs=4, start_lr=0.0, plateau_patience=1,
                      plateau_gamma=0.5)
    tr.fit(state, verbose=False)
    scales = [e["plateau_restart_lr_scale"] for e in _events(tmp_path)
              if e["kind"] == "epoch" and "plateau_restart_lr_scale" in e]
    assert scales and scales == [0.5 ** (i + 1) for i in range(len(scales))]


def test_plateau_restart_loads_best_val_and_a_fresh_optimizer(tmp_path):
    """The restart's parameters are best_val's, its optimizer new at
    start_lr x gamma (its schedule over ``steps_per_epoch``, default 100)."""
    tr, state = _make(tmp_path, n_epochs=2, plateau_patience=1, plateau_gamma=0.5,
                      warmup_steps=0)
    tr.evaluate = lambda st, it=iter([1.0, 2.0]): next(it)  # epoch 1 is a plateau
    out = tr.fit(state, verbose=False)
    best = T.load_params(str(tmp_path / "best_val.ckpt"), PointNetCls(10))
    for a, b in zip(out.model.state_dict().values(), best.state_dict().values()):
        assert torch.equal(a, b)
    assert out.tx.count == 0 and out.step == 0
    assert out.tx.schedule(0) == pytest.approx(0.01 / 64 * 4 * 0.5)


# ---- checkpoints across the packages ---------------------------------------


def _jax_run(tmp_path, cfg, n_batches=3):
    """A JAX ``Trainer.fit`` of 1 epoch: its state and ``last.ckpt``."""
    jmodel = JPointNetCls(n_out=10, dropout=0.0)
    rng = np.random.default_rng(1)
    batches = [{"x": _clouds(rng), "y": rng.integers(0, 10, 4)} for _ in range(n_batches)]

    def jloss(params, apply_fn, batch, r):
        logits, _ = apply_fn({"params": params}, batch["x"])
        ce = -jax.nn.log_softmax(logits)[jnp.arange(len(batch["y"])), batch["y"]]
        return jnp.mean(ce), {}

    jstate = JT.create_state(jmodel, cfg, jnp.asarray(batches[0]["x"]), steps_per_epoch=3)
    tr = JT.Trainer(model=jmodel, cfg=cfg, loss_fn=jloss, train_data=lambda: iter(batches),
                    ckpt_dir=str(tmp_path / "jax"))
    jstate = tr.fit(jstate, n_epochs=1, verbose=False)
    return jmodel, jloss, jstate, str(tmp_path / "jax" / "last.ckpt")


def test_a_jax_checkpoint_decodes_to_optax_state(tmp_path):
    """The structure of a real JAX ``last.ckpt``, as the port reads and
    writes it: the top-level map, and ``opt_state`` as flax serializes
    optax's ``chain(clip, add_decayed_weights, adam)`` state."""
    *_, jstate, path = _jax_run(tmp_path, dict(CFG))
    blob = ckpt.read_checkpoint_blob(path)
    assert sorted(blob) == ["epoch", "opt_state", "params", "step"]
    assert (blob["step"], blob["epoch"]) == (3, 0)
    opt = ckpt.unpackb(blob["opt_state"])
    assert sorted(opt) == ["0", "1", "2"] and opt["0"] == {} and opt["1"] == {}
    adam, sched = opt["2"]["0"], opt["2"]["1"]
    assert sorted(adam) == ["count", "mu", "nu"] and sorted(sched) == ["count"]
    for c in (adam["count"], sched["count"]):
        assert isinstance(c, np.ndarray) and c.dtype == np.int32 and c.shape == () and c == 3
    params = ckpt.unpackb(blob["params"])
    assert _flat(adam["mu"]).keys() == _flat(params).keys() == _flat(adam["nu"]).keys()
    # the port's encoder writes the same bytes back
    assert ckpt.packb(opt) == blob["opt_state"] and ckpt.packb(params) == blob["params"]


def _port_loss(model, batch, train):
    logits, _ = model(batch["x"], train=train)
    return torch.nn.functional.cross_entropy(logits, batch["y"].long()), {}


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_checkpoints_resume_across_packages(tmp_path, opt):
    """A JAX ``last.ckpt`` resumes in the port, and the port's ``last.ckpt``
    in JAX's ``load_checkpoint``: in both directions the next step's loss
    and parameters equal the other package's."""
    cfg = dict(CFG, optimizer_type=opt)
    jmodel, jloss, jstate, jpath = _jax_run(tmp_path, cfg)
    rng = np.random.default_rng(9)
    nxt = {"x": _clouds(rng), "y": rng.integers(0, 10, 4)}
    jstep = JT.make_train_step(jloss, donate=False)

    # JAX -> port
    model = PointNetCls(10, dropout=0.0)
    state = T.TrainState(model=model, tx=T.make_optimizer(model, cfg, 3))
    state, epoch = T.load_checkpoint(jpath, state)
    assert (state.step, epoch, state.tx.count) == (3, 0, 3)
    state, lp, _ = T.make_train_step(_port_loss)(state, T.to_device(nxt, "cpu"))
    jstate2, lj, _ = jstep(jstate, jax.tree.map(jnp.asarray, nxt), jax.random.PRNGKey(0))
    assert abs(float(lp) - float(lj)) <= 1e-5 * abs(float(lj))
    _assert_params_close(model, jstate2.params)

    # port -> JAX
    ppath = str(tmp_path / "port_last.ckpt")
    T.save_checkpoint(ppath, state, 1)
    fresh = JT.create_state(jmodel, cfg, jnp.asarray(nxt["x"]), steps_per_epoch=3)
    jres, jep = JT.load_checkpoint(ppath, fresh)
    assert (int(jres.step), jep) == (4, 1)
    nxt2 = {"x": _clouds(rng), "y": rng.integers(0, 10, 4)}
    jres, lj2, _ = jstep(jres, jax.tree.map(jnp.asarray, nxt2), jax.random.PRNGKey(0))
    state, lp2, _ = T.make_train_step(_port_loss)(state, T.to_device(nxt2, "cpu"))
    assert abs(float(lp2) - float(lj2)) <= 1e-5 * abs(float(lj2))
    _assert_params_close(model, jres.params)


def test_checkpoint_writer_reads_back_in_flax(tmp_path):
    from flax import serialization
    tr, state = _make(tmp_path)
    path = str(tmp_path / "w.ckpt")
    T.save_checkpoint(path, state, 7)
    with open(path, "rb") as f:
        blob_j = serialization.msgpack_restore(f.read())
    blob_p = ckpt.read_checkpoint_blob(path)
    assert sorted(blob_j) == sorted(blob_p) and (blob_j["step"], blob_j["epoch"]) == (0, 7)
    pj = _flat(serialization.msgpack_restore(blob_j["params"]))
    pp = _flat(ckpt.unpackb(blob_p["params"]))
    assert sorted(pj) == sorted(pp)
    for k in pj:
        assert pj[k].dtype == pp[k].dtype and pj[k].tobytes() == pp[k].tobytes()


@pytest.mark.parametrize("net", ["seg", "nunocs", "grasp"])
def test_init_params_from_the_tracked_exports(tmp_path, net):
    """``--init_params`` seeds the parameters from a params-only export
    (``artifacts_tracked/nut/<net>/best_val.ckpt``) with a fresh optimizer;
    the same file cannot ``--resume``."""
    path = f"artifacts_tracked/nut/{net}/best_val.ckpt"
    model = {"seg": lambda: train_seg.build({"voxel_size": 0.002})[0],
             "nunocs": lambda: train_nunocs.build({}, "nut")[0],
             "grasp": lambda: train_grasp.build({"classes": list(range(11))})[0]}[net]()
    state = T.create_state(model, {}, device="cpu")
    state, start = T.start_state(state, init_params=path)
    assert start == 0 and state.step == 0 and state.tx.count == 0
    ref = convert.flax_state_dict(ckpt.read_params(path))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    with pytest.raises(ValueError, match="params-only"):
        T.load_checkpoint(path, state)


# ---- the pipelines on a tiny packed split ----------------------------------


@pytest.fixture(scope="module")
def packed_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenes"))
    out = str(tmp_path_factory.mktemp("packed"))
    gpd.generate_scenes("nut", "train", 4, root, cfg=small_scene_cfg(), seed=1,
                        settle_steps=40, batch=2, device="cpu")
    packed.pack_split(root, out, grasp_db=ptd.load_grasp_dbs("nut"), seed=0, log_every=0)
    return out


def _small_configs(monkeypatch, module, n_pts):
    """The module's configs with fewer points a cloud (a quick CPU run)."""
    load = module.load_config

    def patched(name):
        cfg = load(name)
        cfg["n_pts"] = n_pts
        return cfg

    monkeypatch.setattr(module, "load_config", patched)


def test_grasp_prior_equals_jax(packed_dir, tmp_path, monkeypatch):
    """``prior.json`` of both grasp trainers on the same packed rows (a
    batch larger than the split: no step is taken)."""
    n = len(packed.PackedGrasp(packed_dir, {"classes": [0, 1]}))
    _small_configs(monkeypatch, jtrain_grasp, 64)
    _small_configs(monkeypatch, train_grasp, 64)
    args = ["--data_root", packed_dir, "--n_epochs", "1", "--batch_size", str(n + 1)]
    monkeypatch.setattr("sys.argv", ["train_grasp"] + args + ["--ckpt_dir", str(tmp_path / "j")])
    jtrain_grasp.main()
    train_grasp.main(args + ["--ckpt_dir", str(tmp_path / "p"), "--device", "cpu"])
    with open(tmp_path / "j" / "prior.json") as a, open(tmp_path / "p" / "prior.json") as b:
        pj, pp = json.load(a), json.load(b)
    assert pj == pp and pp["n"] == n and len(pp["bin_prior"]) == 10


def test_the_three_trainers_run_on_the_cpu(packed_dir, tmp_path, monkeypatch):
    """``train_seg``, ``train_nunocs`` and ``train_grasp`` with
    ``--device cpu`` on the tiny split: checkpoints and metrics written,
    the port's predicters and JAX's load them (the same parameters);
    ``--resume`` continues the step count, ``--init_params`` seeds from an
    export, and ``--val_root`` scores each epoch and keeps best_val."""
    for module in (train_nunocs, train_grasp):
        _small_configs(monkeypatch, module, 256)
    ck = tmp_path / "art"
    common = ["--data_root", packed_dir, "--n_epochs", "1", "--device", "cpu"]
    st = train_seg.main(common + ["--batch_size", "2", "--ckpt_dir", str(ck / "seg")])
    assert st.step == 2
    st = train_nunocs.main(common + ["--batch_size", "4", "--ckpt_dir", str(ck / "nunocs")])
    assert st.step >= 1
    st = train_grasp.main(common + ["--batch_size", "8", "--ckpt_dir", str(ck / "grasp")])
    steps = st.step
    assert steps >= 2 and os.path.exists(ck / "grasp" / "prior.json")
    for net in ("seg", "nunocs", "grasp"):
        for name in ("best_train.ckpt", "last.ckpt", "metrics.jsonl"):
            assert os.path.exists(ck / net / name), (net, name)
    port_preds = load_predicters(str(ck), "nut", device="cpu")
    assert sorted(port_preds) == ["grasp", "nocs", "seg"]
    # JAX's predicters load the port's checkpoints: the same parameters
    from catgrasp_tpu.predict.artifacts import load_predicters as jload_predicters
    jax_preds = jload_predicters(str(ck), "nut")
    for role, pred in port_preds.items():
        ref = _flat(jax.tree.map(np.asarray, dict(jax_preds[role].params)))
        mine = _flat(convert.flax_params(pred.model.state_dict()))
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].tobytes() == ref[k].tobytes(), (role, k)
    st = train_grasp.main(common[:2] + ["--n_epochs", "2", "--device", "cpu", "--batch_size",
                                        "8", "--ckpt_dir", str(ck / "grasp"), "--resume",
                                        str(ck / "grasp" / "last.ckpt")])
    assert st.step == 2 * steps
    st = train_grasp.main(common + ["--batch_size", "8", "--ckpt_dir", str(tmp_path / "warm"),
                                    "--init_params", "artifacts_tracked/nut/grasp/best_val.ckpt"])
    assert st.step == steps
    # a val split: per-epoch val losses, best_val.ckpt, the plateau restart
    st = train_grasp.main(common[:2] + ["--n_epochs", "3", "--device", "cpu", "--batch_size", "8",
                                        "--val_root", packed_dir, "--ckpt_dir",
                                        str(tmp_path / "val")])
    events = [json.loads(line) for line in open(tmp_path / "val" / "metrics.jsonl")]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert len(epochs) == 3 and all("val_loss" in e for e in epochs)
    assert os.path.exists(tmp_path / "val" / "best_val.ckpt")
    best = min(range(3), key=lambda i: epochs[i]["val_loss"])
    assert ("plateau_restart_lr_scale" in epochs[2]) == (best == 0)  # patience 2
