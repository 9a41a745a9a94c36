"""The controls on the card, at each cell's own size (its limits were set
there): a sound run is correct, and the plain reference in TF32, put in
the program's place, is not.  These need a CUDA device (TF32 exists only
there) and skip without one: ``python -m pytest benchmark/tests -m chip``
on the card, about a minute a cell."""
import time

import pytest

from benchmark import harness, readings

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("cell", ["nut.train_grasp", "screw.train_nunocs"])
def test_training_control_fails(cell, cuda):
    c = harness.make_cell(harness.benchmark_spec(), cell, 2**31 + 4242, 0.1, False, cuda,
                          time.monotonic())
    drv, keep = harness.driver(c), {}
    result = drv.run(c, keep=keep)
    try:
        sound, lines = harness.check(result.readings, c.limits)
        assert sound, lines
        rows = {r["side"]: r["readings"] for r in readings.controls(c, drv, keep)}
    finally:
        keep["tmp"].cleanup()
    control, lines = harness.check(rows["control_tf32"], c.limits)
    assert not control, lines
