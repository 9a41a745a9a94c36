"""Share of the window's wall spent in evaluation (``train.evaluate``: the
val batches built, copied and run, and the mean read back), in %."""
from benchmark.yardstick import spans


def read(layer: dict):
    return spans.share_of_window(layer, "train.evaluate")
