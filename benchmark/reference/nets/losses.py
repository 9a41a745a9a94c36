"""The training losses of the two nets, written out in plain PyTorch.

- The grasp net: the cross-entropy over the score bins, plus the ordinal
  auxiliary (smooth-L1, beta 0.1, of the softmax's expected bin against
  the label bin, both over the last bin index), plus 1e-3 x the feature
  transform's regulariser (the batch mean of ||I - A A^T||_F^2).
- The NUNOCS net (upstream ``loss.py:NocsMinSymmetryCELoss``): per
  symmetry of the category, the target coordinates are centred, turned and
  shifted by the symmetry and binned; the cross-entropy, summed over the 3
  axes and averaged over the points, is minimised over the symmetries for
  each cloud and averaged over the batch."""
from __future__ import annotations

import torch


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


def grasp_loss(logits: torch.Tensor, label: torch.Tensor, trans_feat: torch.Tensor,
               ordinal_weight: float = 1.0) -> torch.Tensor:
    n = logits.shape[-1]
    ce = -log_softmax(logits).gather(-1, label[:, None]).mean()
    expected = (torch.softmax(logits, dim=-1) * torch.arange(n, dtype=logits.dtype,
                                                             device=logits.device)).sum(-1)
    err = (expected - label.to(logits.dtype)) / (n - 1.0)
    ordinal = torch.where(err.abs() < 0.1, 5.0 * err.square(), err.abs() - 0.05).mean()
    eye = torch.eye(trans_feat.shape[-1], dtype=trans_feat.dtype, device=trans_feat.device)
    off = eye - torch.bmm(trans_feat, trans_feat.transpose(1, 2))
    return ce + ordinal_weight * ordinal + 1e-3 * off.square().sum(dim=(1, 2)).mean()


def nocs_loss(logits: torch.Tensor, nocs: torch.Tensor, symmetries: torch.Tensor,
              bins: int) -> torch.Tensor:
    """logits (B, N, 3 bins); nocs (B, N, 3) in [0, 1]; symmetries (S, 4, 4)."""
    B, N = nocs.shape[:2]
    logp = log_softmax(logits.reshape(B, N, 3, bins))
    centred = nocs - 0.5
    per_symmetry = []
    for tf in symmetries:
        target = centred @ tf[:3, :3].T + tf[:3, 3] + 0.5
        idx = torch.clamp((target * bins).long(), 0, bins - 1)
        ce = -logp.gather(-1, idx[..., None])[..., 0].sum(-1).mean(-1)  # (B,)
        per_symmetry.append(ce)
    return torch.stack(per_symmetry, dim=-1).amin(dim=-1).mean()
