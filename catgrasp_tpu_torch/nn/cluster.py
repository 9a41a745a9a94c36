"""Flat-kernel MeanShift (``catgrasp_tpu/nn/cluster.py:mean_shift`` in
PyTorch), the seg predicter's clustering of shifted points.

``connected_components`` and the ``segment_*`` reducers of the JAX module
serve training only and are not here.
"""
from __future__ import annotations

import torch

N_ITER = 12  # shifts of each seed


def weighted_draw(p: torch.Tensor, shape: tuple, generator: torch.Generator | None = None):
    """Indices into ``p`` (N,), drawn with replacement in proportion to
    ``p``: the inverse CDF of uniform draws, as ``jax.random.choice(...,
    p=p)`` computes them (all-zero ``p`` gives index 0, with no error)."""
    cum = torch.cumsum(p, 0)
    u = torch.rand(shape, generator=generator, device=p.device, dtype=p.dtype)
    return torch.searchsorted(cum, cum[-1] * (1 - u))


def mean_shift(points: torch.Tensor, bandwidth: float, mask: torch.Tensor | None = None,
               n_seeds: int = 128, generator: torch.Generator | None = None):
    """Cluster points (N, 3) -> (labels (N,), modes (n_seeds, 3), n_modes).

    Seeds are drawn among the valid points; each shifts ``N_ITER`` times to
    the mean of the valid points within ``bandwidth``; a seed joins the
    lowest-index seed within ``bandwidth / 2`` (4 pointer jumps), owners are
    relabelled densely, and every valid point takes its nearest surviving
    mode's label.  Invalid points (mask False) get -1."""
    n, dev = points.shape[0], points.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    p = mask.float()
    p = p / torch.clamp(p.sum(), min=1.0)
    seeds = points[weighted_draw(p, (n_seeds,), generator)]
    # the bandwidth in f32, as the jitted JAX function receives it
    bw = torch.tensor(bandwidth, dtype=points.dtype, device=dev)
    bw2 = bw * bw
    for _ in range(N_ITER):
        d2 = ((seeds[:, None, :] - points[None]) ** 2).sum(-1)  # (S, N)
        w = ((d2 <= bw2) & mask[None]).to(points.dtype)
        seeds = (w @ points) / torch.clamp(w.sum(-1, keepdim=True), min=1.0)

    # merge: seed i joins the lowest-index seed within bandwidth / 2
    d2 = ((seeds[:, None] - seeds[None]) ** 2).sum(-1)
    owner = torch.argmax((d2 <= (bw / 2) ** 2).to(torch.uint8), dim=-1)
    for _ in range(4):
        owner = owner[owner]
    uniq = owner == torch.arange(n_seeds, device=dev)
    mode_label = (torch.cumsum(uniq, 0) - 1)[owner]

    d2p = ((points[:, None] - seeds[None]) ** 2).sum(-1)  # (N, S)
    d2p = torch.where(uniq[None, :], d2p, torch.inf)
    labels = torch.where(mask, mode_label[torch.argmin(d2p, dim=-1)], -1)
    return labels, seeds, uniq.sum()
