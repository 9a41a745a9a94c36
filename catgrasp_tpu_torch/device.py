"""Device selection shared by the port's entry points."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU.  Without one this raises instead of quietly
    running on the CPU: a caller that wants the host says ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "catgrasp_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant tensor held on ``device``, made once per (values, dtype,
    device).  A loop that needs it every step then copies nothing from the
    host: a copy from pageable host memory makes the host wait for the
    stream.  The tensor is shared, so callers never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
