"""The per-layer metrics read from the port's spans (``yardstick/spans.py``):
a traced run of each cell, at a size a CPU test holds, reads all seven
through ``harness.metrics_of``, and the input path's three parts fit
inside the host's wait that the harness's feed measures around them."""
import pytest

from benchmark import harness

from .conftest import tiny_cell

SPANS = ("train.input_read_ms", "train.input_resample_ms", "train.input_transform_ms",
         "train.to_device_ms", "train.enqueue_ms", "train.ckpt_share", "train.eval_share")
PARTS = SPANS[:3]


@pytest.mark.parametrize("name", ["nut.train_grasp", "screw.train_nunocs"])
def test_traced_run_reads_the_spans(name):
    cell = tiny_cell(name)
    cell.trace = True
    cell.mix["profile_steps"] = [1, 2, 4]  # inside the first epoch of the window
    result = harness.driver(cell).run(cell)
    spec = harness.benchmark_spec()
    spec = {**spec, "per_layer": [m for m in spec["per_layer"] if m["name"] in SPANS]}
    got = {k: v["value"] for k, v in harness.metrics_of(spec, name, result, True).items()}
    assert set(got) == set(SPANS)
    assert all(v > 0 for v in got.values()), got
    assert got["train.ckpt_share"] + got["train.eval_share"] < 100
    wait = harness.reader("train.data_wait_ms")(result.layer)
    assert sum(got[m] for m in PARTS) <= wait
    assert harness.check(result.readings, cell.limits)[0]


def test_readers_read_nothing_without_a_fit(monkeypatch):
    from catgrasp_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_last_fit", None)
    layer = {"steps": 10, "wall_s": 2.0}
    assert all(harness.reader(m)(layer) is None for m in SPANS)
    monkeypatch.delattr(profiling, "last_fit")  # a program without the registry
    assert all(harness.reader(m)(layer) is None for m in SPANS)
