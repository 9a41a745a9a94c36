"""Host milliseconds a training step spent drawing and taking each row's
points (``input.next/input.resample``: ``_batch_indices``, the gather and the
cast) over the window."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.ms_per_step(layer, "input.next/input.resample")
