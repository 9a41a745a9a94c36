"""The paired training protocol on the CPU at a small size: JAX's
``Trainer.fit`` and the port's from the tracked nut exports, at the nets'
full widths, on one tiny packed split made by the port
(``scripts/train_parity_protocol.py``, ``scripts/train_parity_jax.py``):
the same batches, the grasp net's dropout masks carried into both, through
three epoch ends with val, ``best_val`` and the plateau revert (patience 1
here, so an epoch without a val improvement reverts; the seg net in f32).
Every step's loss and every epoch's val loss within 1e-5 relative (the
seg net's 5e-4), every learning rate within 1e-6, the same ``best_val``
epoch and the same reverts; and the val loss taken as JAX's ``evaluate``
takes it."""
import numpy as np
import pytest
import torch

from scripts import train_parity_jax as tpj
from scripts import train_parity_protocol as tpp
from test_torch_common import small_scene_cfg

torch.set_num_threads(2)

# Found: NUNOCS and grasp within 3e-7 of JAX over every step; the seg net's
# first loss within 3e-6, then up to 1.3e-4 apart by its sixth step (its
# U-Net's f32 sums in other orders, which Adam's steps on near-zero
# gradients carry into the parameters)
LOSS_REL = {"seg": 5e-4, "nunocs": 1e-5, "grasp": 1e-5}
LR_REL = 1e-6
# points a cloud cut as the trainer tests cut them; the seg net's grid cut
# to 16x16x8 voxels of 1.5 cm (its channels, the width, stay) and its convs
# run in f32 in both packages: bf16 alone moves the two packages' losses
# ~1e-4 apart from the first step (``tests/test_torch_trainer.py`` holds
# the bf16 gradients; the protocol trains in bf16)
SMALL = {"seg": dict(batch=2, n_pts=512,
                     cfg_overrides={"voxel_size": 0.015, "grid_dims": [16, 16, 8]}),
         "nunocs": dict(batch=4, n_pts=64), "grasp": dict(batch=16, n_pts=64)}


@pytest.fixture
def f32_seg(monkeypatch):
    """Both packages' seg nets with f32 convs."""
    import functools

    import jax.numpy as jnp

    from catgrasp_tpu.nn.voxelnet import SegNet
    from catgrasp_tpu.pipelines import train_seg as jtrain_seg
    from catgrasp_tpu_torch.nn import voxelnet

    monkeypatch.setattr(jtrain_seg, "SegNet", functools.partial(SegNet, compute_dtype=jnp.float32))
    monkeypatch.setattr(voxelnet, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """4 small nut scenes packed; their rows serve as the val split too."""
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.pipelines import generate_pile_data as gpd
    from catgrasp_tpu_torch.pipelines import pack_training_data as ptd

    root = str(tmp_path_factory.mktemp("scenes"))
    out = str(tmp_path_factory.mktemp("packed"))
    gpd.generate_scenes("nut", "train", 4, root, cfg=small_scene_cfg(), seed=1,
                        settle_steps=40, batch=2, device="cpu")
    packed.pack_split(root, out, grasp_db=ptd.load_grasp_dbs("nut"), seed=0, log_every=0)
    return out, out


@pytest.mark.parametrize("net", tpp.NETS)
def test_paired_training_matches_jax(split, tmp_path, net, f32_seg):
    kw = dict(SMALL[net], n_epochs=3)
    kw["cfg_overrides"] = dict(kw.get("cfg_overrides", {}), plateau_patience=1)
    j = tpj.run_jax(net, split, "jax", out_root=str(tmp_path), **kw)
    p = tpp.run_port(net, split, "cpu", "port", out_root=str(tmp_path), **kw)
    assert j["n_steps"] == p["n_steps"] >= 3 and len(j["epochs"]) == len(p["epochs"]) == 3
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_REL[net])
    np.testing.assert_allclose(p["lr"], j["lr"], rtol=LR_REL)
    np.testing.assert_allclose([e["val_loss"] for e in p["epochs"]],
                               [e["val_loss"] for e in j["epochs"]], rtol=LOSS_REL[net])
    assert p["best_val_epoch"] == j["best_val_epoch"]
    assert ([e["plateau_lr_scale"] for e in p["epochs"]]
            == [e["plateau_lr_scale"] for e in j["epochs"]])
    d = tpp.diff(p, j)
    assert d["param_rel_l2"] < 1e-3, d["param_rel_l2"]


def test_nudge_and_masks_are_the_same_draws():
    """The floor's nudge is 1e-6 relative and a function of the leaf's path;
    a step's dropout mask is a function of the step, and the val mask is
    its own."""
    a = np.linspace(1, 2, 12, dtype=np.float32).reshape(3, 4)
    n1, n2 = tpp.nudge("x/kernel", a), tpp.nudge("x/kernel", a)
    assert np.array_equal(n1, n2) and not np.array_equal(n1, tpp.nudge("y/kernel", a))
    assert 0 < np.abs(n1 / a - 1).max() < 1e-5
    m = [tpp.drop_mask(s, 8, 0.6) for s in (-1, 0, 1, 0)]
    assert m[0].shape == (8, tpp.DROP_WIDTH) and np.array_equal(m[1], m[3])
    assert not np.array_equal(m[0], m[1]) and not np.array_equal(m[1], m[2])
    assert abs(np.mean(m[1]) - 0.6) < 0.05


def _rec(run, val, loss=(1.0, 2.0)):
    epochs = [{"epoch": i, "train_loss": 1.0, "val_loss": v, "plateau_lr_scale": None}
              for i, v in enumerate(val)]
    return {"net": "grasp", "run": run, "n_steps": len(loss), "loss": list(loss),
            "lr": [1.0] * len(loss), "epochs": epochs, "params": None,
            "best_val_epoch": tpp.best_val_epoch(epochs)}


def test_compare_bands(monkeypatch):
    """``compare``: the band of each epoch is max(2 x the floor's
    difference, 1e-3); another best_val epoch or a val loss outside the band
    fails the comparison."""
    monkeypatch.setattr(tpp, "param_rel_l2", lambda a, b: 0.0)
    b = _rec("b", [2.0, 1.0, 1.5])
    floor = _rec("f", [2.0, 1.004, 1.5])
    ok = tpp.compare(_rec("a", [2.001, 1.007, 1.5]), b, floor)
    assert ok["ok"] and ok["val_band"] == pytest.approx([1e-3, 8e-3, 1e-3])
    bad = tpp.compare(_rec("a", [2.003, 1.0, 1.5]), b, floor)
    assert not bad["ok"] and "epoch 0" in bad["breaches"][0]
    moved = tpp.compare(_rec("a", [2.0, 1.0, 0.999]), b, floor)
    assert not moved["ok"] and "best_val epoch 2 against 1" in moved["breaches"][0]
    assert tpp.best_val_epoch(b["epochs"]) == 1


def test_val_loss_is_the_training_loss_from_seed_0():
    """``Trainer.evaluate`` takes the val loss as JAX's does: the loss in
    training mode (the grasp net's dropout on) with each batch's draws from
    seed 0, so two calls agree, the training stream is left where it was,
    and the loss differs from the one with dropout off."""
    from catgrasp_tpu_torch.nn.pointnet import PointNetCls
    from catgrasp_tpu_torch.train import trainer as T

    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(4, 64, 6)).astype(np.float32),
                "y": rng.integers(0, 10, 4)} for _ in range(2)]

    def loss(model, batch, train):
        logits, _ = model(batch["x"], train=train)
        return torch.nn.functional.cross_entropy(logits, batch["y"].long()), {}

    model = PointNetCls(10)
    state = T.create_state(model, {"random_seed": 0}, device="cpu")
    tr = T.Trainer(model=model, cfg={}, loss_fn=loss, train_data=lambda: iter(batches),
                   val_data=lambda: iter(batches))
    torch.manual_seed(5)
    before = torch.random.get_rng_state()
    v1, v2 = tr.evaluate(state), tr.evaluate(state)
    assert v1 == v2 and torch.equal(torch.random.get_rng_state(), before)
    with torch.no_grad():
        off = float(torch.stack([loss(model, T.to_device(b, "cpu"), False)[0]
                                 for b in batches]).mean())
    assert abs(v1 - off) > 1e-6
