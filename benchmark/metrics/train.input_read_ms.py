"""Host milliseconds a training step spent gathering its memmapped rows
(the port's ``input.read`` span inside ``input.next``) over the window."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.ms_per_step(layer, "input.next/input.read")
