"""The yardstick's arithmetic: the frozen operation count against
``chip_smoke.py``'s, the statistics, the rate and share readers, the
trace reduction and the comparisons."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.yardstick import compare, flops, stats, trace

import chip_smoke


@pytest.mark.parametrize("shape", [(240, 2048, False, 10), (34, 8192, True, 300),
                                   (3, 17, True, 7), (1, 1, False, 1)])
def test_pointnet_macs_is_chip_smoke_s(shape):
    assert flops.pointnet_macs(*shape) == chip_smoke.pointnet_macs(*shape)


def test_p90_has_ten_beyond_at_a_hundred_steps():
    values = [float(v) for v in range(1, 101)]
    p = stats.p90(values)
    assert p == pytest.approx(90.1) and stats.beyond(values, p) == 10
    with pytest.raises(ValueError):
        stats.p90([1.0])


def test_mfu_reader():
    layer = {"steps": 10, "wall_s": 2.0, "val_batches": 3, "fwd_macs": 1e12,
             "peak_flop_per_s": 67e12}
    # (3 x 2e12 x 10 + 2e12 x 3) / 2 s / 67e12
    assert harness.reader("train.mfu")(layer) == pytest.approx(100 * 66e12 / 2 / 67e12)


def _event(name, start, end, cuda, parent=None):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           cpu_parent=parent)


def test_trace_summary_unions_and_labels_gaps():
    events = [_event("aten::mm", 0, 10, False), _event("k1", 5, 15, True),
              _event("k2", 12, 20, True), _event("aten::copy_", 20, 40, False),
              _event("k3", 30, 35, True), _event("cudaLaunchKernel", 1, 2, False, parent=1)]
    s = trace.summarize(events)
    assert s["launches"] == 3
    assert s["busy_s"] == pytest.approx(20e-6) and s["window_s"] == pytest.approx(40e-6)
    assert dict(s["idle_gaps"]) == pytest.approx({"aten::mm": 5e-6, "aten::copy_": 10e-6})
    assert s["device_ops"][0][0] in ("k1", "k2")
    idle = harness.reader("device_idle.train")({"trace": s})
    assert idle == pytest.approx(50.0)


def test_leaf_gap_and_still_leaves():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "still": torch.full((4,), 1e-9)}
    assert compare.moving_leaves(ref) == ["a", "b"]
    prog = {"a": torch.ones(4), "b": torch.full((4,), 2.2), "still": torch.zeros(4)}
    # b: |4.4 - 4| / max(4, median 2) = 0.1
    assert compare.leaf_gap(prog, ref, ["a", "b"]) == pytest.approx(0.1)
    assert compare.leaf_gap({"a": torch.ones(4)}, ref, ["a", "b"]) == compare.SIZE_MISMATCH
    # median of a: 0 and b: 0.1
    assert compare.median_leaf_gap(prog, ref, ["a", "b"]) == pytest.approx(0.05)


def test_loss_gap():
    assert compare.loss_gap([2.0, 1.0], [2.0, 1.1]) == pytest.approx(0.1 / 1.1)
    assert compare.loss_gap([2.0], [2.0, 1.1]) == compare.SIZE_MISMATCH


def test_check_prints_each_number_beside_its_limit():
    ok, lines = harness.check({"a": 0.1, "b": 0.3}, {"a": 0.2, "b": 0.2})
    assert not ok and lines == ["a 0.1 limit 0.2", "b 0.3 limit 0.2 FAILED"]
    ok, _ = harness.check({}, {"a": 0.2})
    assert not ok
