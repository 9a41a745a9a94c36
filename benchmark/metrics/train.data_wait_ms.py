"""Host milliseconds a step spent inside the dataset's batch iterator (the
port's ``Packed*.batches``) over the window."""


def read(layer: dict):
    return 1e3 * layer["wait_s"] / layer["steps"] if layer.get("steps") else None
