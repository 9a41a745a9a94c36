"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): the bounds a share of a peak is taken against."""

F32_FLOP_PER_S = 67e12  # float32 off the tensor cores
TF32_FLOP_PER_S = 495e12


def matmul_peak() -> tuple[float, str]:
    """(FLOP/s, name) of the precision float32 matrix products run in under
    the process's current settings: TF32 on the tensor cores when
    ``torch.backends.cuda.matmul.allow_tf32`` is set, else float32 off them."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        return TF32_FLOP_PER_S, "tf32"
    return F32_FLOP_PER_S, "f32"
