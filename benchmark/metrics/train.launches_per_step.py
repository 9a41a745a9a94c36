"""Device operations a training step launches, from the profiler's trace
of the traced steps."""


def read(layer: dict):
    trace = layer.get("trace")
    if not trace or not trace["launches"] or not trace.get("steps"):
        return None
    return trace["launches"] / trace["steps"]
