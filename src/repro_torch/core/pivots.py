"""Pivot selection strategies (paper §4.1) — PyTorch port.

The three strategies of the JAX package's ``core.pivots``, with the same
numpy ``default_rng(seed)`` draw order, so both packages draw the same
candidate sets from the same data. The distance work runs in torch on
the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["select_pivots", "pairwise_sqdist"]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (na, nb), clamped at 0."""
    a2 = (a * a).sum(-1, keepdim=True)           # (na, 1)
    b2 = (b * b).sum(-1, keepdim=True).T         # (1, nb)
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def _sample(data: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    if data.shape[0] <= n:
        return np.asarray(data)
    idx = rng.choice(data.shape[0], size=n, replace=False)
    return np.asarray(data[idx])


def _random_selection(data, m, *, n_sets, rng, device):
    """Paper: draw T random candidate sets, keep the one with max total
    pairwise distance (a spread heuristic), all T scored in one batch."""
    cands = np.stack([_sample(data, m, rng).astype(np.float32)
                      for _ in range(max(1, n_sets))])        # (T, m, dim)
    c = torch.as_tensor(cands, device=device)
    n2 = (c * c).sum(-1)                                      # (T, m)
    d2 = (n2[:, :, None] + n2[:, None, :]
          - 2.0 * torch.einsum("tmd,tnd->tmn", c, c))
    scores = torch.sqrt(torch.clamp(d2, min=0.0)).sum(dim=(1, 2))
    return cands[int(torch.argmax(scores))]


def _farthest_selection(data, m, *, sample, rng, device):
    """Iterative farthest-point: maximize sum of distance to chosen pivots."""
    pts = _sample(data, sample, rng).astype(np.float32)
    first = int(rng.integers(pts.shape[0]))
    pts_t = torch.as_tensor(pts, device=device)
    chosen = [first]
    acc = torch.sqrt(pairwise_sqdist(pts_t, pts_t[first:first + 1]))[:, 0]
    for _ in range(1, m):
        acc[chosen] = -float("inf")  # never re-pick
        nxt = int(torch.argmax(acc))
        chosen.append(nxt)
        acc = torch.where(
            torch.isneginf(acc), acc,
            acc + torch.sqrt(pairwise_sqdist(pts_t, pts_t[nxt:nxt + 1]))[:, 0])
    return pts[np.asarray(chosen)]


def _kmeans_selection(data, m, *, sample, rng, device, iters: int = 10):
    """k-means on a sample; cluster centers become pivots."""
    pts = torch.as_tensor(_sample(data, sample, rng).astype(np.float32),
                          device=device)
    init_idx = rng.choice(pts.shape[0], size=m, replace=False)
    centers = pts[torch.as_tensor(init_idx, device=device)]
    for _ in range(iters):
        assign = torch.argmin(pairwise_sqdist(pts, centers), dim=1)
        sums = torch.zeros_like(centers).index_add_(0, assign, pts)
        cnts = torch.zeros((m,), dtype=pts.dtype, device=device).index_add_(
            0, assign, torch.ones_like(pts[:, 0]))[:, None]
        # empty cluster keeps its previous center
        centers = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0),
                              centers)
    return centers.cpu().numpy()


def select_pivots(
    data: np.ndarray,
    m: int,
    strategy: str = "random",
    *,
    sample: int = 4096,
    n_sets: int = 8,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Select ``m`` pivots from ``data`` using a paper §4.1 strategy.
    Returns a host float32 array (pivots are O(M·dim)). The distance
    work runs on ``device`` (the card by default)."""
    device = resolve_device(device)
    data = np.asarray(data)
    if m > data.shape[0]:
        raise ValueError(f"cannot select {m} pivots from {data.shape[0]} objects")
    rng = np.random.default_rng(seed)
    if strategy == "random":
        out = _random_selection(data, m, n_sets=n_sets, rng=rng,
                                device=device)
    elif strategy == "farthest":
        out = _farthest_selection(data, m, sample=max(sample, m), rng=rng,
                                  device=device)
    elif strategy == "kmeans":
        out = _kmeans_selection(data, m, sample=max(sample, m), rng=rng,
                                device=device)
    else:
        raise ValueError(f"unknown pivot strategy {strategy!r}")
    return np.ascontiguousarray(out, dtype=np.float32)
