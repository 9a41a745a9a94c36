"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
harness on the CPU at tiny sizes, and, marked ``chip``, the controls on a
CUDA device, which skip without one (decided inside the test)."""
import time

import pytest
import torch

from benchmark import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only the card has")
    return torch.device("cuda")


def tiny_cell(name: str, seed: int = 2**31 + 11, device="cpu", seconds: float = 0.1):
    """Cell ``name`` at a size a CPU test holds: the nets at batch 4 of 64
    points, on splits of a few batches."""
    torch.set_num_threads(2)
    cell = harness.make_cell(harness.benchmark_spec(), name, seed, seconds, False,
                             torch.device(device), time.monotonic())
    cell.config["net"].update(batch_size=4, n_pts=64)
    if cell.mix["net"] == "grasp":
        cell.mix.update(row_pts=128, train={"clouds": 8, "keys": 40}, val={"clouds": 2, "keys": 8})
    else:
        cell.mix.update(row_pts=64, train={"rows": 20}, val={"rows": 8})
    return cell
