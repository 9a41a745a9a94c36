"""Training losses (``catgrasp_tpu/nn/losses.py`` in PyTorch).

``nocs_min_symmetry_ce`` is the reference's NocsMinSymmetryCELoss
(``loss.py:16-45``): a 100-bin cross-entropy per NUNOCS axis against every
symmetry transform of the target, the minimum over symmetries per sample.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def nocs_min_symmetry_ce(pred_logits: torch.Tensor, target_nocs: torch.Tensor,
                         symmetry_tfs: torch.Tensor, n_bins: int = 100) -> torch.Tensor:
    """pred_logits (B, N, 3 n_bins); target_nocs (B, N, 3) in [0, 1];
    symmetry_tfs (S, 4, 4).  Targets are centred (-0.5), mapped through each
    symmetry, shifted back (+0.5) and binned; the CE is summed over the 3
    axes, averaged over points, minimised over symmetries and averaged over
    the batch."""
    B, N = target_nocs.shape[:2]
    centered = target_nocs - 0.5
    R, t = symmetry_tfs[:, :3, :3], symmetry_tfs[:, :3, 3]
    tgt = torch.einsum("sij,bnj->bsni", R, centered) + t[None, :, None, :] + 0.5
    bins = torch.clamp((tgt * n_bins).to(torch.int64), 0, n_bins - 1)  # (B, S, N, 3)
    logp = F.log_softmax(pred_logits.reshape(B, N, 3, n_bins), dim=-1)
    # the target bin's log-probability for each symmetry, (B, N, 3, S)
    lp = torch.gather(logp, -1, bins.permute(0, 2, 3, 1))
    per_sym = torch.mean(-torch.sum(lp, dim=2), dim=1)  # (B, S)
    return torch.mean(torch.amin(per_sym, dim=-1))


def grasp_quality_ce(logits: torch.Tensor, score_bins: torch.Tensor) -> torch.Tensor:
    """CE over the 10 perturbation-score bins."""
    return F.cross_entropy(logits, score_bins.long())


def grasp_quality_ordinal(logits: torch.Tensor, score_bins: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 (beta 0.1) of the expected bin under the softmax against
    the label bin, both over the last bin index: the ordinal auxiliary of
    the grasp-quality head."""
    p = torch.softmax(logits, dim=-1)
    idx = torch.arange(logits.shape[-1], dtype=p.dtype, device=p.device)
    expq = torch.sum(p * idx, dim=-1)
    err = (expq - score_bins.to(p.dtype)) / (logits.shape[-1] - 1.0)
    return torch.mean(torch.where(torch.abs(err) < 0.1, 0.5 * err * err / 0.1,
                                  torch.abs(err) - 0.05))


def offset_loss(pred_offsets: torch.Tensor, gt_offsets: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Instance-centre offset regression: masked L1 distance plus a cosine
    direction term (PointGroup's offset loss, ``pointgroup.py:363-402``).
    Leading axes ahead of the points axis are scenes, each reduced alone:
    (..., N, 3) -> (...)."""
    w = valid.float()
    denom = torch.clamp(w.sum(dim=-1), min=1.0)
    dist = torch.sum(torch.abs(pred_offsets - gt_offsets), dim=-1)
    l_dist = torch.sum(dist * w, dim=-1) / denom
    gt_n = gt_offsets / (torch.linalg.vector_norm(gt_offsets, dim=-1, keepdim=True) + 1e-8)
    pr_n = pred_offsets / (torch.linalg.vector_norm(pred_offsets, dim=-1, keepdim=True) + 1e-8)
    l_dir = torch.sum((1.0 - torch.sum(gt_n * pr_n, dim=-1)) * w, dim=-1) / denom
    return l_dist + l_dir
