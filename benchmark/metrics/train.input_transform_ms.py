"""Host milliseconds a training step spent on the batch's frame transform,
flip, normalisation and labels (``input.next/input.transform``) over the
window."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.ms_per_step(layer, "input.next/input.transform")
