"""Batched RANSAC 9-DoF fit (``catgrasp_tpu/predict/ransac.py`` in
PyTorch): rotation, translation and per-axis scale mapping a predicted
NUNOCS cloud onto the camera cloud.

All hypotheses are one batched program: 4 drawn point pairs give an exact
affine map (a 4x4 solve with 1e-9 on the diagonal), A = M | t with M =
R diag(s); gates on the per-axis scales, on R's singular values in [0.8,
1.2] and on det(polar(R)) > 0; the score is the inlier ratio at
``pass_threshold``; the winner is the first hypothesis with the best ratio.
"""
from __future__ import annotations

import torch

from ..nn.cluster import weighted_draw

N_HYPOTHESES = 1000


def estimate_9d_transform(source: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                          pass_threshold: float, max_scale: torch.Tensor | None = None,
                          min_scale: torch.Tensor | None = None,
                          generator: torch.Generator | None = None):
    """source / target (N, 3) with a valid-point mask (N,) -> (transform
    (4, 4), inlier ratio (), inlier mask (N,)) of the best of
    ``N_HYPOTHESES``; the ratio is 0 when no hypothesis passed the
    gates."""
    n, dev, dt = source.shape[0], source.device, source.dtype
    max_scale = torch.full((3,), 99.0, device=dev) if max_scale is None else max_scale
    min_scale = torch.zeros(3, device=dev) if min_scale is None else min_scale
    valid = mask.to(dt)
    ids = weighted_draw(valid / torch.clamp(valid.sum(), min=1.0), (N_HYPOTHESES, 4), generator)

    src_h = torch.cat([source, torch.ones_like(source[:, :1])], dim=-1)
    eye4 = torch.eye(4, dtype=dt, device=dev)
    # A^T = S^-1 Tg, the exact affine map through 4 point pairs; a singular
    # S gives non-finite entries, which the gates reject
    At = torch.linalg.solve_ex(src_h[ids] + 1e-9 * eye4, target[ids])[0]  # (I, 4, 3)
    M, t = At[:, :3, :].transpose(1, 2), At[:, 3, :]  # (I, 3, 3), (I, 3)
    scales = torch.linalg.vector_norm(M, dim=1)  # column norms (I, 3)
    ok = (scales <= max_scale).all(-1) & (scales >= min_scale).all(-1)
    R = M / torch.clamp(scales[:, None, :], min=1e-9)
    R = torch.where(torch.isfinite(R), R, 0.0)  # the SVD takes finite input only
    u, s, vh = torch.linalg.svd(R)
    ok &= (s.amin(-1) >= 0.8) & (s.amax(-1) <= 1.2)
    R_o = u @ vh
    ok &= torch.linalg.det(R_o) > 0
    M_o = R_o * scales[:, None, :]
    T = eye4.repeat(N_HYPOTHESES, 1, 1)
    T[:, :3, :3] = M_o
    T[:, :3, 3] = t

    mapped = source @ M_o.transpose(1, 2) + t[:, None, :]  # (I, N, 3)
    inl = (torch.linalg.vector_norm(mapped - target, dim=-1) <= pass_threshold) & mask
    ratio = inl.sum(-1) / torch.clamp(mask.sum(), min=1)
    ratio = torch.where(ok & torch.isfinite(T).all(-1).all(-1), ratio, 0.0)
    best = torch.argmax(ratio)
    return T[best], ratio[best], inl[best]
