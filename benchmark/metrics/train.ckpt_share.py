"""Share of the window's wall spent writing checkpoints (``ckpt.save``: the
host copy of the parameters and Adam's moments, msgpack, the write), in %."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.share_of_window(layer, "ckpt.save")
