"""CaTGrasp's two PointNet heads written out as functions of one dict of
parameters, in plain PyTorch: the grasp-quality classifier (score-bin
logits of a cloud) and the per-point NUNOCS head (3 axes x bins), over the
shared encoder with an input and a feature spatial transformer (upstream
``pointnet2.py``: ``STN3d``/``STNkd``, ``PointNetEncoder``, ``PointNetCls``,
``PointNetSeg``).

Parameters are keyed as the port's modules name them
(``PointNetEncoder_0.STN_0.MLPStack_0.Dense_0.weight``), so the benchmark
hands one dict of weights to both sides; nothing here is the port's code.

Every layer acts on the last axis of a (B, N, C) or (B, C) tensor:
- a dense layer is ``x W^T + b``;
- a group norm normalises each sample over its points and a group of
  channels (``min(8, C)`` groups, reduced until they divide C), about the
  mean, with the biased variance and epsilon 1e-6, then scales and shifts;
- a shared MLP is dense -> group norm -> ReLU per width;
- dropout keeps each unit with probability 1 - p and scales it by
  1 / (1 - p), its mask drawn from torch's generator by ``F.dropout``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

GN_EPS = 1e-6
DROPOUT = 0.4  # after the classifier's 512-wide layer, in training


def n_groups(c: int) -> int:
    g = min(8, c)
    while c % g:
        g -= 1
    return g


def dense(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def group_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    shape, c = x.shape, x.shape[-1]
    g = n_groups(c)
    y = x.reshape(shape[0], -1, g, c // g)  # (B, points, groups, channels a group)
    mean = y.mean(dim=(1, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((y - mean) / torch.sqrt(var + GN_EPS)).reshape(shape)
    return y * p[f"{name}.weight"] + p[f"{name}.bias"]


def mlp(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    i = 0
    while f"{name}.Dense_{i}.weight" in p:
        x = torch.relu(group_norm(p, f"{name}.GroupNorm_{i}", dense(p, f"{name}.Dense_{i}", x)))
        i += 1
    return x


def transformer(p: dict, name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """A (B, k, k) alignment: the identity plus what the pooled MLP predicts."""
    h = mlp(p, f"{name}.MLPStack_0", x).amax(dim=1)
    m = dense(p, f"{name}.Dense_0", mlp(p, f"{name}.MLPStack_1", h))
    return m.reshape(-1, k, k) + torch.eye(k, dtype=m.dtype, device=m.device)


def encoder(p: dict, x: torch.Tensor):
    """(global feature (B, 1024), per-point feature (B, N, 64), the 3x3 and
    the 64x64 transform) of a (B, N, C) cloud whose first 3 channels are
    xyz; the input transform sees every channel and turns only xyz."""
    e = "PointNetEncoder_0"
    trans = transformer(p, f"{e}.STN_0", x, 3)
    x = torch.cat([torch.bmm(x[..., :3], trans), x[..., 3:]], dim=-1)
    x = mlp(p, f"{e}.MLPStack_0", x)
    trans_feat = transformer(p, f"{e}.STN_1", x, 64)
    point_feat = torch.bmm(x, trans_feat)
    h = group_norm(p, f"{e}.GroupNorm_0",
                   dense(p, f"{e}.Dense_0", mlp(p, f"{e}.MLPStack_1", point_feat)))
    return h.amax(dim=1), point_feat, trans, trans_feat


def classifier(p: dict, x: torch.Tensor, train: bool):
    """(score-bin logits (B, bins), the feature transform)."""
    g, _, _, trans_feat = encoder(p, x)
    h = F.dropout(mlp(p, "MLPStack_0", g), DROPOUT, train)
    return dense(p, "Dense_0", mlp(p, "MLPStack_1", h)), trans_feat


def segmenter(p: dict, x: torch.Tensor):
    """Per-point logits (B, N, 3 x bins): each point's feature beside the
    cloud's global one."""
    g, point_feat, _, _ = encoder(p, x)
    h = torch.cat([g[:, None, :].expand(-1, x.shape[1], -1), point_feat], dim=-1)
    return dense(p, "Dense_0", mlp(p, "MLPStack_0", h))
