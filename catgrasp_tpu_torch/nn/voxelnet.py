"""Instance-segmentation net (``catgrasp_tpu/nn/voxelnet.py`` in
PyTorch): voxelize the scene cloud into a dense grid, a 3-level dense 3-D
U-Net, and per-point heads (an offset to the instance centre, bounded to 5
cm, and an objectness logit).

Precision follows the JAX module's default ``compute_dtype``: the
convolutions and transposed convolutions run in bfloat16 (inputs, kernels,
outputs and the bias add), every GroupNorm and the head in float32; the
parameters stay float32 and gradients flow through the same casts.  The
head's GroupNorm and its ReLU run on the card through the hand-written op
``ops/row_group_norm.py:row_group_norm_relu`` (CUDA kernels for rows that
are each their own sample), on the CPU through its plain version.
Convolutions pad SAME (1 voxel for 3x3x3).  Submodules carry the flax names
(``VoxelUNet_0.ConvBlock_3.Conv_1``) for ``convert.flax_state_dict``;
the grid runs in torch's (B, C, D, H, W) layout.  A batch of scenes (the
trainer's; JAX ``vmap``s the one-scene net) is voxelized with a scene index
into one grid per scene, and each scene is normalised alone.

``SegNet.forward``'s four parts are spans of ``utils/profiling.py``
(``seg.voxelize``, ``seg.unet``, ``seg.gather``, ``seg.head``): host
seconds and calls of the enqueue, with no device wait.  They launch device
work, so they are never profiler ranges.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import constant
from ..ops.row_group_norm import row_group_norm_relu
from ..utils.profiling import span
from .pointnet import GN_EPS

COMPUTE_DTYPE = torch.bfloat16
N_FEATS = 3  # per-point features: the normal


def voxelize(xyz: torch.Tensor, feats: torch.Tensor, origin: torch.Tensor,
             voxel_size: float, grid_dims: tuple):
    """Mean-pool point features into a dense grid: xyz (N, 3), feats (N, C)
    -> (grid (D, H, W, C + 1), the last channel occupancy in {0, 1}; the
    flat voxel index of each point (N,)).  Points outside the grid are
    clipped to its border voxels, not dropped.  One ``index_add_``.
    Leading scene axes (B, N, ...) with origin (B, 3) give a grid per scene
    (B, D, H, W, C + 1) and indices within each scene's grid (B, N), still
    in one ``index_add_`` over the scene-indexed voxels."""
    D, H, W = grid_dims
    lead = xyz.shape[:-2]
    dev = xyz.device
    # times the f32 reciprocal, not over the voxel size: XLA rewrites the
    # JAX module's division by a constant so under jit, which is how the
    # net was trained and is run; a point on a voxel face (a flat face at
    # a whole number of voxels from the origin) lands a voxel lower
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    ijk = torch.floor((xyz - origin[..., None, :]) * inv).to(torch.int64)
    hi = constant((D - 1, H - 1, W - 1), torch.int64, dev)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi)
    flat = (ijk[..., 0] * H + ijk[..., 1]) * W + ijk[..., 2]
    n_vox = D * H * W
    B = int(np.prod(lead)) if lead else 1
    scene = (flat.reshape(B, -1) + torch.arange(B, device=dev)[:, None] * n_vox).reshape(-1) \
        if lead else flat
    f = torch.cat([feats, torch.ones_like(feats[..., :1])], dim=-1)
    f = f.reshape(-1, f.shape[-1])
    sums = f.new_zeros((B * n_vox, f.shape[1])).index_add_(0, scene, f)
    count = torch.clamp(sums[:, -1:], min=1.0)
    grid = torch.cat([sums[:, :-1] / count, torch.clamp(sums[:, -1:], max=1.0)], dim=-1)
    return grid.reshape(*lead, D, H, W, -1), flat


def _conv(conv: nn.Module, x: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """flax's Conv / ConvTranspose with dtype=bfloat16: input, kernel and
    output in bf16, the bias added to the bf16 output."""
    dt = COMPUTE_DTYPE
    if transposed:
        y = F.conv_transpose3d(x.to(dt), conv.weight.to(dt), stride=2)
    else:
        y = F.conv3d(x.to(dt), conv.weight.to(dt), padding=1)
    return y + conv.bias.to(dt)[:, None, None, None]


class ConvBlock(nn.Module):
    """(3x3x3 conv -> GroupNorm -> ReLU) x 2."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        g = min(8, features)
        self.Conv_0 = nn.Conv3d(in_features, features, 3, padding=1)
        self.GroupNorm_0 = nn.GroupNorm(g, features, eps=GN_EPS)
        self.Conv_1 = nn.Conv3d(features, features, 3, padding=1)
        self.GroupNorm_1 = nn.GroupNorm(g, features, eps=GN_EPS)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(_conv(self.Conv_0, x).float()))
        return F.relu(self.GroupNorm_1(_conv(self.Conv_1, x).float()))


class VoxelUNet(nn.Module):
    """3-level dense U-Net over (B, C, D, H, W) grids -> (B, base, D, H, W)."""

    def __init__(self, in_features: int = 4, base: int = 16):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_features, base)
        self.ConvBlock_1 = ConvBlock(base, base * 2)
        self.ConvBlock_2 = ConvBlock(base * 2, base * 4)
        self.ConvTranspose_0 = nn.ConvTranspose3d(base * 4, base * 2, 2, stride=2)
        self.ConvBlock_3 = ConvBlock(base * 4, base * 2)
        self.ConvTranspose_1 = nn.ConvTranspose3d(base * 2, base, 2, stride=2)
        self.ConvBlock_4 = ConvBlock(base * 2, base)

    def forward(self, grid):
        e1 = self.ConvBlock_0(grid)
        e2 = self.ConvBlock_1(F.max_pool3d(e1, 2))
        e3 = self.ConvBlock_2(F.max_pool3d(e2, 2))
        u2 = _conv(self.ConvTranspose_0, e3, transposed=True).float()
        u2 = self.ConvBlock_3(torch.cat([u2, e2], dim=1))
        u1 = _conv(self.ConvTranspose_1, u2, transposed=True).float()
        return self.ConvBlock_4(torch.cat([u1, e1], dim=1))


class SegNet(nn.Module):
    """(xyz (N, 3), normals (N, 3), origin (3,)) -> (offsets (N, 3), objectness
    logits (N,)), over a ``grid_dims`` grid of ``voxel_size`` voxels whose
    corner is ``origin``.  A batch of scenes (B, N, 3), (B, N, 3), (B, 3)
    gives (B, N, 3), (B, N): each scene as the one-scene call gives it."""

    def __init__(self, base: int = 16, voxel_size: float = 0.004,
                 grid_dims: tuple = (96, 96, 48)):
        super().__init__()
        self.voxel_size, self.grid_dims = voxel_size, tuple(grid_dims)
        self.VoxelUNet_0 = VoxelUNet(N_FEATS + 1, base)
        self.Dense_0 = nn.Linear(3 + N_FEATS + base, 64)
        self.GroupNorm_0 = nn.GroupNorm(8, 64, eps=GN_EPS)
        self.Dense_1 = nn.Linear(64, 64)
        self.Dense_2 = nn.Linear(64, 3)
        self.Dense_3 = nn.Linear(64, 1)

    def forward(self, xyz, feats, origin):
        if xyz.dim() == 2:
            off, obj = self.forward(xyz[None], feats[None], origin[None])
            return off[0], obj[0]
        B, N = xyz.shape[:2]
        with span("seg.voxelize", device_work=True):
            grid, flat = voxelize(xyz, feats, origin, self.voxel_size, self.grid_dims)
        with span("seg.unet", device_work=True):
            # (B, base, D, H, W) from a contiguous (B, C, D, H, W) grid: the
            # permuted view would make torch pick channels-last conv kernels,
            # which round the bf16 convs otherwise than the NCDHW ones
            vox = self.VoxelUNet_0(grid.permute(0, 4, 1, 2, 3).contiguous())
        with span("seg.gather", device_work=True):
            vox = vox.reshape(B, vox.shape[1], -1).transpose(1, 2)  # (B, D H W, base)
            per_pt = torch.take_along_dim(vox, flat[..., None], dim=1)  # one gather
        with span("seg.head", device_work=True):
            # the head runs on the (B N, C) points: its GroupNorm normalises
            # each point alone, as flax's does on one scene's (N, 64); on the
            # card it and its ReLU are one hand-written op, forward and backward
            h = torch.cat([xyz - origin[:, None], feats, per_pt], dim=-1).reshape(B * N, -1)
            gn = self.GroupNorm_0
            h = row_group_norm_relu(self.Dense_0(h), gn.weight, gn.bias, gn.num_groups, gn.eps)
            h = F.relu(self.Dense_1(h))
            # offsets bounded to the parts' scale (1-5 cm)
            off = 0.05 * torch.tanh(self.Dense_2(h))
            return off.reshape(B, N, 3), self.Dense_3(h)[:, 0].reshape(B, N)
