"""Distance metrics for the join (paper §2.1: the methods apply to any
metric with the triangle inequality — L2, L1 (Manhattan), L∞ (max)).

PyTorch port of the JAX package's ``core.metrics``. The canonical
per-pair chain (:func:`canonical_gathered`) is an unrolled left-to-right
float32 ``acc = acc + d_t * d_t`` of separate eager ops — no fused
multiply-add — and a correctly rounded √, so a (q, s) pair gives the
same bits on the CPU and on the card, whatever the batch around it.
"""
from __future__ import annotations

import torch

METRICS = ("l2", "l1", "linf")

__all__ = ["METRICS", "pairwise_dist", "cmp_dist", "select_dist",
           "sq_dist64", "from_cmp", "canonical_gathered", "gathered_dist",
           "canonical_topk"]


def pairwise_dist(a: torch.Tensor, b: torch.Tensor, metric: str = "l2",
                  *, block: int = 2048) -> torch.Tensor:
    """True (non-squared) distances, shape (na, nb). Blocked over rows."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if metric == "l2":
        d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
              - 2.0 * (a @ b.T))
        return torch.sqrt(torch.clamp(d2, min=0.0))
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    for lo in range(0, a.shape[0], block):
        diff = (a[lo:lo + block, None, :] - b[None, :, :]).abs()
        out[lo:lo + block] = (diff.sum(-1) if metric == "l1"
                              else diff.amax(-1))
    return out


def cmp_dist(a: torch.Tensor, b: torch.Tensor, metric: str = "l2",
             *, block: int = 2048) -> torch.Tensor:
    """Distances in *comparable* space (monotone in true distance):
    squared for L2 (cheaper; no sqrt), true distance otherwise.

    The L2 path recenters both sets by b's mean first: distances are
    translation-invariant, but the ‖a‖²+‖b‖²−2ab cancellation noise is
    O(‖x‖²·eps) — on data far from the origin that noise dwarfs real
    kNN gaps and corrupts top-k *selection*. Centering shrinks it to
    O(spread²·eps) for two O(n·dim) passes.
    """
    if metric != "l2":
        return pairwise_dist(a, b, metric, block=block)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    c = (b.to(torch.float64).mean(0).to(torch.float32) if b.shape[0]
         else torch.zeros(b.shape[1], dtype=torch.float32, device=b.device))
    a = a - c
    b = b - c
    d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.clamp(d2, min=0.0)


def sq_dist64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (na, nb) in float64: the expansion on rows
    centered by b's mean."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    c = (b.mean(0) if b.shape[0]
         else torch.zeros(b.shape[1], dtype=torch.float64, device=b.device))
    a = a - c
    b = b - c
    d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.clamp(d2, min=0.0)


def select_dist(a: torch.Tensor, b: torch.Tensor, metric: str = "l2",
                *, block: int = 2048) -> torch.Tensor:
    """:func:`cmp_dist` for top-k *selection* and pruning tests in the
    host reducers (dense, pruned): the L2 expansion is taken in float64
    (:func:`sq_dist64`) and rounded once to float32. A tile of
    pivot-sorted rows spans a whole Voronoi cell, so centering on its
    mean leaves a float32 cancellation noise of the cell's spread² · eps
    — on map coordinates (OSM-like rows) more than the gap between a
    query's k-th and (k+1)-th neighbours (ROADMAP C15). Rounding the
    float64 value keeps the order up to float32 ties."""
    if metric != "l2":
        return pairwise_dist(a, b, metric, block=block)
    return sq_dist64(a, b).to(torch.float32)


def from_cmp(d: torch.Tensor, metric: str) -> torch.Tensor:
    """Comparable space → true distance. The L2 √ is taken in float64
    and rounded once: the correctly rounded float32 √ on every backend,
    as numpy's is."""
    if metric != "l2":
        return d
    return torch.sqrt(d.to(torch.float64)).to(d.dtype)


def canonical_gathered(q: torch.Tensor, neigh: torch.Tensor,
                       metric: str = "l2") -> torch.Tensor:
    """The canonical per-pair distance chain.

    ``q`` (n, dim) vs ``neigh`` (n, k, dim) → (n, k) float32 true
    distances. The reduction over ``dim`` is an unrolled left-to-right
    chain of separate elementwise float32 ops, so every (q, s) pair
    gives the same bits whatever the leading shape and whichever device
    runs it. The megastep's stage 5 and the brute-force oracle both call
    this one function.
    """
    d = q[:, None, :].to(torch.float32) - neigh.to(torch.float32)
    if metric == "l2":
        d = d * d
        acc = d[..., 0]
        for t in range(1, d.shape[-1]):
            acc = acc + d[..., t]
        # √ in float64, rounded once: the correctly rounded float32 √ on
        # every backend (a CPU build's vectorised float32 √ may be off by
        # an ulp where CUDA's is exact)
        return torch.sqrt(acc.to(torch.float64)).to(torch.float32)
    a = d.abs()
    acc = a[..., 0]
    for t in range(1, a.shape[-1]):
        acc = acc + a[..., t] if metric == "l1" else torch.maximum(
            acc, a[..., t])
    return acc


def gathered_dist(q: torch.Tensor, neigh: torch.Tensor, metric: str = "l2",
                  *, block: int = 8192) -> torch.Tensor:
    """:func:`canonical_gathered` over ``block``-row chunks (bounded
    memory for large one-shot calls; per-row values do not depend on
    the chunking)."""
    n, k = neigh.shape[:2]
    if n == 0 or k == 0 or q.shape[1] == 0:
        return torch.zeros((n, k), dtype=torch.float32, device=q.device)
    return torch.cat([canonical_gathered(q[lo:lo + block],
                                         neigh[lo:lo + block], metric)
                      for lo in range(0, n, block)])


def canonical_topk(q: torch.Tensor, ids: torch.Tensor, neigh: torch.Tensor,
                   metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Finalize a top-k result: recompute the k selected distances in the
    canonical form and re-sort each row ascending by them (stable, so
    engine tie order survives). ``ids < 0`` slots stay at +inf/-1.
    The *selection* of the k set remains the engine's (exact over a
    superset); only the reported values and their order are re-derived.
    """
    d = gathered_dist(q, neigh, metric)
    d = torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
    order = torch.argsort(d, dim=1, stable=True)
    return (torch.take_along_dim(d, order, dim=1),
            torch.take_along_dim(ids, order, dim=1))
