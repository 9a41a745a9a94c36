"""PointNet heads (``catgrasp_tpu/nn/pointnet.py`` in PyTorch): the
grasp-quality classifier ``PointNetCls`` (10 score bins) and the per-point
NUNOCS head ``PointNetSeg`` (3 axes x 100 bins), over the shared-MLP
encoder with an input STN and a feature STN, and the feature transform's
regularizer.  ``PointNetCls`` drops units when called with ``train=True``,
as the flax module does: each kept with probability 1 - p and scaled by
1 / (1 - p).  Without it (the default, as in JAX) the call is deterministic.

Submodules carry the flax module names (``PointNetEncoder_0.STN_1...``),
so ``convert.flax_state_dict`` maps a checkpoint one to one.  Layers
act on the last axis of (B, N, C) or (B, C), as flax's do.  Two details
of flax's GroupNorm hold: it reduces over the points axis and the channel
group together (torch's ``group_norm`` on (B, C, N)), and its epsilon is
1e-6.  The group count is ``min(8, C)``, reduced until it divides C.
Compute is f32, as the JAX predicters run these nets.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax.linen.GroupNorm's default


def _groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def channels_last_gn(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's GroupNorm on the last axis: per sample over every other
    non-batch axis and the channel group."""
    if x.dim() == 2:
        return gn(x)
    return gn(x.movedim(-1, 1)).movedim(1, -1)


class MLPStack(nn.Module):
    """Dense -> GroupNorm -> ReLU per width."""

    def __init__(self, in_features: int, features: tuple):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(in_features, f))
            self.add_module(f"GroupNorm_{i}", nn.GroupNorm(_groups(f), f, eps=GN_EPS))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            x = F.relu(channels_last_gn(getattr(self, f"GroupNorm_{i}"), x))
        return x


class STN(nn.Module):
    """Spatial transformer predicting a k x k alignment matrix from a
    (B, N, in_features) cloud."""

    def __init__(self, k: int, in_features: int):
        super().__init__()
        self.k = k
        self.MLPStack_0 = MLPStack(in_features, (64, 128, 1024))
        self.MLPStack_1 = MLPStack(1024, (512, 256))
        self.Dense_0 = nn.Linear(256, k * k)

    def forward(self, x):
        h = self.MLPStack_0(x).amax(dim=1)  # (B, 1024)
        m = self.Dense_0(self.MLPStack_1(h))
        eye = torch.eye(self.k, dtype=m.dtype, device=m.device).reshape(-1)
        return (m + eye).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """xyz STN (it sees every input channel; only xyz is transformed), a
    64-wide MLP, the feature STN, then 128 and 1024 wide and a max pool.
    Returns (global feature (B, 1024), per-point feature (B, N, 64), the
    3x3 and 64x64 transforms)."""

    def __init__(self, in_features: int = 6):
        super().__init__()
        self.STN_0 = STN(3, in_features)
        self.MLPStack_0 = MLPStack(in_features, (64,))
        self.STN_1 = STN(64, 64)
        self.MLPStack_1 = MLPStack(64, (128,))
        self.Dense_0 = nn.Linear(128, 1024)
        self.GroupNorm_0 = nn.GroupNorm(8, 1024, eps=GN_EPS)

    def forward(self, x):  # (B, N, D); the first 3 channels are xyz
        trans = self.STN_0(x)
        x = torch.cat([x[..., :3] @ trans, x[..., 3:]], dim=-1)
        x = self.MLPStack_0(x)
        trans_feat = self.STN_1(x)
        point_feat = x @ trans_feat  # (B, N, 64)
        x = channels_last_gn(self.GroupNorm_0, self.Dense_0(self.MLPStack_1(point_feat)))
        return x.amax(dim=1), point_feat, trans, trans_feat


class PointNetCls(nn.Module):
    """Grasp-quality classifier: a cloud in the grasp frame (B, N, 6) ->
    (score-bin logits (B, n_out), the feature transform).  ``dropout`` is
    the drop rate after the 512-wide layer when ``train`` is set."""

    def __init__(self, n_out: int = 10, in_features: int = 6, dropout: float = 0.4):
        super().__init__()
        self.dropout = dropout
        self.PointNetEncoder_0 = PointNetEncoder(in_features)
        self.MLPStack_0 = MLPStack(1024, (512,))
        self.MLPStack_1 = MLPStack(512, (256,))
        self.Dense_0 = nn.Linear(256, n_out)

    def forward(self, x, train: bool = False):
        g, _, _, trans_feat = self.PointNetEncoder_0(x)
        h = F.dropout(self.MLPStack_0(g), self.dropout, train)
        return self.Dense_0(self.MLPStack_1(h)), trans_feat


class PointNetSeg(nn.Module):
    """Per-point head: (B, N, 6) -> (NUNOCS bin logits (B, N, n_out), the
    feature transform); n_out = 3 x bins.  ``train`` changes nothing (the
    flax module takes it too)."""

    def __init__(self, n_out: int = 300, in_features: int = 6):
        super().__init__()
        self.PointNetEncoder_0 = PointNetEncoder(in_features)
        self.MLPStack_0 = MLPStack(1088, (512, 256, 128))
        self.Dense_0 = nn.Linear(128, n_out)

    def forward(self, x, train: bool = False):
        g, point_feat, _, trans_feat = self.PointNetEncoder_0(x)
        h = torch.cat([g[:, None, :].expand(-1, x.shape[1], -1), point_feat], dim=-1)
        return self.Dense_0(self.MLPStack_0(h)), trans_feat


def feature_transform_regularizer(trans_feat: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of ||I - A A^T||_F^2 of the 64x64 feature
    transforms A (B, 64, 64)."""
    k = trans_feat.shape[-1]
    eye = torch.eye(k, dtype=trans_feat.dtype, device=trans_feat.device)
    d = eye - trans_feat @ trans_feat.transpose(-1, -2)
    return torch.mean(torch.sum(d * d, dim=(-2, -1)))
