"""Host milliseconds a training step spent enqueuing its forward, backward,
clip and Adam (``train.step``; the device runs behind it) over the window."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.ms_per_step(layer, "train.step")
