"""Pinhole camera model and depth <-> point-cloud conversions
(``catgrasp_tpu/core/camera.py`` in PyTorch).

``Camera`` keeps its intrinsics ``K`` as a numpy array, as the JAX class
does; the three functions take tensors and compute on their device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    """Intrinsics + image size.  ``K`` is the usual 3x3 pinhole matrix.

    The defaults are the reference camera's (``config/config.yml``)."""

    K: np.ndarray
    H: int = 1544
    W: int = 2064
    zfar: float = 3.0
    znear: float = 0.1

    @staticmethod
    def from_config(cfg: dict) -> "Camera":
        K = np.array(cfg["K"], dtype=np.float32).reshape(3, 3)
        return Camera(K=K, H=int(cfg["H"]), W=int(cfg["W"]), zfar=float(cfg.get("zfar", 3.0)))

    def scaled(self, factor: float) -> "Camera":
        """Downscale the camera (render at reduced resolution)."""
        K = self.K.copy().astype(np.float32)
        K[:2] *= factor
        return Camera(K=K, H=int(round(self.H * factor)), W=int(round(self.W * factor)),
                      zfar=self.zfar, znear=self.znear)


def depth_to_xyzmap(depth: torch.Tensor, K: torch.Tensor, min_depth: float = 0.1) -> torch.Tensor:
    """Back-project a depth image (..., H, W) into an organized xyz map
    (..., H, W, 3) in the camera frame.  Invalid pixels (depth < min_depth)
    map to zero."""
    H, W = depth.shape[-2], depth.shape[-1]
    K = torch.as_tensor(K, dtype=depth.dtype, device=depth.device)
    vs = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    us = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    zs = depth
    xs = (us - K[0, 2]) * zs / K[0, 0]
    ys = (vs - K[1, 2]) * zs / K[1, 1]
    xyz = torch.stack([xs, ys, zs], dim=-1)
    return torch.where((depth < min_depth)[..., None], 0.0, xyz)


def pixel_rays(K: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Unit ray direction per pixel, (H, W, 3) in camera frame (+z forward),
    on the device of ``K``."""
    K = torch.as_tensor(K, dtype=torch.float32)
    vs = torch.arange(H, dtype=torch.float32, device=K.device)[:, None]
    us = torch.arange(W, dtype=torch.float32, device=K.device)[None, :]
    xs = (us - K[0, 2]) / K[0, 0]
    ys = (vs - K[1, 2]) / K[1, 1]
    xs, ys = torch.broadcast_tensors(xs, ys)
    d = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def project_points(pts_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixel coords (..., 2) = (u, v)."""
    K = torch.as_tensor(K, dtype=pts_cam.dtype, device=pts_cam.device)
    z = torch.clamp(pts_cam[..., 2:3], min=1e-9)
    u = pts_cam[..., 0:1] / z * K[0, 0] + K[0, 2]
    v = pts_cam[..., 1:2] / z * K[1, 1] + K[1, 2]
    return torch.cat([u, v], dim=-1)
