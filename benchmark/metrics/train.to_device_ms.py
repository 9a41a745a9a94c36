"""Host milliseconds a training step spent handing its batch to the device
(``input.to_device``: pinning and the enqueued copies) over the window."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.ms_per_step(layer, "input.to_device")
