"""Occlusion-aware background densification from a depth scan
(``catgrasp_tpu/geom/occupancy.py`` in PyTorch).

A camera-frame depth image encodes the scan's visibility function: a voxel
center projected to pixel (u, v) is occupied iff its depth is at or behind
the observed depth(u, v) - pad.  One projection and one image lookup per
voxel, fully vectorized.
"""
from __future__ import annotations

import torch


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace`` arithmetic: lo*(1-s) + hi*s with s = i/(num-1), and
    the last point exactly ``hi`` — the grid the JAX package builds, to the
    last bit."""
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=lo.device) / div
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def occupancy_from_depth(depth: torch.Tensor, K: torch.Tensor,
                         lower: torch.Tensor, upper: torch.Tensor,
                         grid_dims: tuple = (64, 64, 32), pad: float = 0.005):
    """Occupied-voxel mask over an AABB in the CAMERA frame.

    depth (H, W) metric, 0 = invalid; returns (centers (V, 3), occupied (V,))
    with V = prod(grid_dims)."""
    H, W = depth.shape
    D1, D2, D3 = grid_dims
    gx = _linspace(lower[0], upper[0], D1)
    gy = _linspace(lower[1], upper[1], D2)
    gz = _linspace(lower[2], upper[2], D3)
    X, Y, Z = torch.meshgrid(gx, gy, gz, indexing="ij")
    centers = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)

    z = torch.clamp(centers[:, 2], min=1e-6)
    u = torch.clamp((centers[:, 0] / z * K[0, 0] + K[0, 2]).to(torch.int32), 0, W - 1)
    v = torch.clamp((centers[:, 1] / z * K[1, 1] + K[1, 2]).to(torch.int32), 0, H - 1)
    d_obs = depth[v.long(), u.long()]
    occupied = (d_obs > 0) & (z >= d_obs - pad)
    return centers, occupied


def background_cloud_from_depth(depth: torch.Tensor, K: torch.Tensor,
                                seg: torch.Tensor, target_id: int,
                                grid_dims: tuple = (64, 64, 32),
                                pad: float = 0.005,
                                center: torch.Tensor | None = None,
                                reach: float = 0.12):
    """Collision cloud for grasp filtering around one target segment: all
    occupied voxels except the target object's own surface.  The grid spans
    ``center ± reach`` (or the scan's extent when ``center`` is None).

    Returns (points (V,3), mask (V,)) fixed-shape."""
    K = torch.as_tensor(K, dtype=torch.float32, device=depth.device)
    valid = depth > 0
    if center is None:
        xs, ys = _x_of(depth, K), _y_of(depth, K)
        inf = torch.tensor(float("inf"), device=depth.device)
        lower = torch.stack([torch.where(valid, xs, inf).amin(),
                             torch.where(valid, ys, inf).amin(),
                             torch.where(valid, depth, inf).amin()]) - pad
        upper = torch.stack([torch.where(valid, xs, -inf).amax(),
                             torch.where(valid, ys, -inf).amax(),
                             torch.where(valid, depth, -inf).amax()]) + pad
    else:
        center = torch.as_tensor(center, dtype=torch.float32, device=depth.device)
        lower = center - reach
        upper = center + reach
    depth_bg = torch.where(seg == target_id, 0.0, depth)
    return occupancy_from_depth(depth_bg, K, lower, upper, grid_dims, pad)


def _x_of(depth, K):
    W = depth.shape[1]
    us = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    return (us - K[0, 2]) * depth / K[0, 0]


def _y_of(depth, K):
    H = depth.shape[0]
    vs = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    return (vs - K[1, 2]) * depth / K[1, 1]
