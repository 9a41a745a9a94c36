"""A run of each cell kind with its timed path broken underneath comes out
not correct, and a sound run correct: the harness's look for a chip
skipped, everything else as a run does it, at a size a CPU test holds."""
import pytest

from benchmark import harness
from benchmark.drivers import train as train_driver

from .conftest import tiny_cell


def _correct(cell_name: str, seed: int = 2**31 + 11) -> bool:
    cell = tiny_cell(cell_name, seed)
    result = harness.driver(cell).run(cell)
    return harness.check(result.readings, cell.limits)[0]


# ---- training -------------------------------------------------------------


def _no_update(self):
    self.count += 1


def _no_update_in_the_window(inner):
    def step(self):
        if self.count < train_driver.REF_STEPS:
            return inner(self)
        self.count += 1
    return step


def _batches(mutate):
    def patch(monkeypatch, cls):
        inner = cls.batches

        def batches(self, *args, **kwargs):
            for batch in inner(self, *args, **kwargs):
                yield mutate(dict(batch))
        monkeypatch.setattr(cls, "batches", batches)
    return patch


def _half(batch):
    return {k: v[: len(v) // 2] for k, v in batch.items()}


def _label(batch):
    if "label" in batch:
        batch["label"] = batch["label"].copy()
        batch["label"][0] = (batch["label"][0] + 5) % 10
    else:
        batch["nocs"] = batch["nocs"].copy()
        batch["nocs"][0] = 1.0 - batch["nocs"][0]
    return batch


TRAIN_FAULTS = {"state_unchanged": None, "state_unchanged_in_the_window": None,
                "half_the_batch": _batches(_half), "answer_altered": _batches(_label)}


@pytest.mark.parametrize("cell", ["nut.train_grasp", "screw.train_nunocs"])
@pytest.mark.parametrize("fault", [None, *TRAIN_FAULTS])
def test_training_fault_is_caught(cell, fault, monkeypatch):
    from catgrasp_tpu_torch.data import packed
    from catgrasp_tpu_torch.train import trainer as T
    if fault == "state_unchanged":
        monkeypatch.setattr(T.Optimizer, "step", _no_update)
    elif fault == "state_unchanged_in_the_window":
        monkeypatch.setattr(T.Optimizer, "step", _no_update_in_the_window(T.Optimizer.step))
    elif fault is not None:
        for cls in (packed.PackedGrasp, packed.PackedNunocs):
            TRAIN_FAULTS[fault](monkeypatch, cls)
    assert _correct(cell) is (fault is None)
