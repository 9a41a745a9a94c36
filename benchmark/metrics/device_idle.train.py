"""Share of the traced training steps' wall in which no operation ran on the
device, in %."""


def read(layer: dict):
    trace = layer.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
