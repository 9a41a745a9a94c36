"""Clustering of points (``catgrasp_tpu/nn/cluster.py`` in PyTorch):
flat-kernel MeanShift, the seg predicter's clustering of shifted points;
ε-graph connected components; and per-cluster mean, min and max reducers.
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


def connected_components(points: torch.Tensor, radius: float, mask: torch.Tensor | None = None,
                         n_sweeps: int = 16) -> torch.Tensor:
    """ε-graph connected components by min-label propagation (N up to a few
    thousand): two points connect if within ``radius``, and each of
    ``n_sweeps`` sweeps lowers a point's label to its neighbours' least, so
    a component's labels reach its lowest point index when its graph
    diameter is within ``n_sweeps`` (a longer chain keeps partial labels, as
    the JAX function does).  Returns labels (N,), -1 for masked-out points."""
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    d2 = torch.sum((points[:, None] - points[None]) ** 2, dim=-1)
    adj = (d2 <= radius * radius) & mask[:, None] & mask[None, :]
    labels = torch.where(mask, torch.arange(n, device=points.device), n)
    for _ in range(n_sweeps):
        neigh = torch.where(adj, labels[None, :], n)
        labels = torch.minimum(labels, torch.amin(neigh, dim=-1))
    return torch.where(mask, labels, -1)


def _segment_reduce(values: torch.Tensor, labels: torch.Tensor, num_segments: int, reduce: str,
                    fill: float) -> torch.Tensor:
    """``reduce`` of ``values`` by label into ``fill``-initialised segments;
    negative labels go to an extra segment that is dropped."""
    idx = torch.where(labels >= 0, labels, num_segments).long()
    idx = idx.reshape(idx.shape + (1,) * (values.dim() - 1)).expand_as(values)
    out = torch.full((num_segments + 1,) + values.shape[1:], fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, idx, values, reduce=reduce)[:num_segments]


def segment_mean(values: torch.Tensor, labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-cluster mean of ``values`` (N, ...) by ``labels`` (N,); negative
    labels are dropped, an empty cluster reads 0."""
    sums = _segment_reduce(values, labels, num_segments, "sum", 0.0)
    cnt = _segment_reduce(torch.ones(labels.shape, dtype=torch.float32, device=labels.device),
                          labels, num_segments, "sum", 0.0)
    return sums / torch.clamp(cnt[:, None], min=1.0)


def segment_min(values: torch.Tensor, labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-cluster min; negative labels are dropped, an empty cluster reads
    +inf."""
    return _segment_reduce(values, labels, num_segments, "amin", float("inf"))


def segment_max(values: torch.Tensor, labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-cluster max; negative labels are dropped, an empty cluster reads
    -inf."""
    return _segment_reduce(values, labels, num_segments, "amax", float("-inf"))
