"""The window's share of the card's peak, in %: the FLOPs of its training
steps (three times the forward's, two a multiply-add of
``yardstick.flops.pointnet_macs``) and of its evaluation forwards, over the
window's seconds, against the peak of the precision float32 products ran
in (``yardstick.peaks.matmul_peak``)."""


def read(layer: dict):
    if not layer.get("steps") or not layer.get("wall_s"):
        return None
    fwd = 2 * layer["fwd_macs"]
    done = 3 * fwd * layer["steps"] + fwd * layer["val_batches"]
    return 100.0 * done / layer["wall_s"] / layer["peak_flop_per_s"]
