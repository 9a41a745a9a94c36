"""The plain reference against the port at a tiny size on the CPU: a net's
first steps from the weights, and its next from the port's state."""
import pytest
import torch

from benchmark.drivers import train as train_driver
from benchmark.reference import training
from benchmark.yardstick import compare

from .conftest import tiny_cell


@pytest.mark.parametrize("cell", ["nut.train_grasp", "screw.train_nunocs"])
def test_training_reference_follows_the_port_s_steps(cell, tmp_path):
    """The reference's steps against the port's train step on the same
    split, weights and dropout stream: three from the weights on one pass
    over the split, then two from the port's state on the next pass."""
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.pipelines import train_grasp, train_nunocs
    from catgrasp_tpu_torch.train import trainer as T

    c = tiny_cell(cell)
    cfg, dev = c.config["net"], torch.device("cpu")
    dirs = train_driver.write_splits(str(tmp_path), c.mix, c.seed, dev)
    if c.mix["net"] == "grasp":
        model, loss_fn = train_grasp.build(cfg)
        ds = packed.PackedGrasp(dirs["train"], cfg)
    else:
        model, loss_fn = train_nunocs.build(cfg, c.config["class_name"])
        ds = packed.PackedNunocs(dirs["train"], cfg)
    bs = cfg["batch_size"]
    state = T.create_state(model, cfg, max(len(ds) // bs, 1), device=dev)
    weights = train_driver.make_weights(model, c.seed, dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    step = T.make_train_step(loss_fn)
    losses, window_losses = [], []
    torch.manual_seed(c.seed)
    for _, batch in zip(range(3), ds.batches(bs)):
        state, loss, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(loss))
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = state.tx.opt.state
    start = {"count": state.tx.count, **{key: {n: moments[p][key].clone() for n, p in state.tx.named}
                                         for key in ("exp_avg", "exp_avg_sq")}}
    torch.manual_seed(c.seed + 1)
    for _, batch in zip(range(2), ds.batches(bs)):
        state, loss, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        window_losses.append(float(loss))
    net, cls = c.mix["net"], c.config["class_name"]
    ref = training.steps(net, cfg, cls, dirs["train"], weights, 3, c.seed, dev)
    ref_w = training.steps(net, cfg, cls, dirs["train"], after, 2, c.seed + 1, dev, state=start,
                           after=3)
    assert compare.loss_gap(losses, ref["losses"]) < 1e-6
    assert compare.loss_gap(window_losses, ref_w["losses"]) < 1e-6
    change = compare.leaf_gap(compare.change(after, weights), compare.change(ref["params"], weights),
                              compare.moving_leaves(ref["first_grad"]))
    assert change < 1e-4


def test_lr_schedule_is_the_port_s():
    from catgrasp_tpu_torch.train.trainer import multistep_lr
    cfg = {"start_lr": 0.01, "batch_size": 240, "lr_milestones": [2, 3], "warmup_steps": 5}
    port = multistep_lr(0.01, 240, [2, 3], 4, warmup_steps=5)
    ref = training.lr_schedule(cfg, 4)
    assert [ref(k) for k in range(20)] == [port(k) for k in range(20)]
    cfg["warmup_steps"] = 0
    port = multistep_lr(0.01, 240, [2, 3], 4)
    assert [training.lr_schedule(cfg, 4)(k) for k in range(20)] == [port(k) for k in range(20)]
