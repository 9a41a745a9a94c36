"""Device selection shared by the port's entry points."""
from __future__ import annotations

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
