"""Distance bounds of PGBJ (paper §4.3, Theorems 1-6, Algorithms 1-2) —
PyTorch port of the JAX package's ``core.bounds``.

Everything here is a function of the summary tables and the pivot-pivot
distance matrix only — O(M² + M·k) work, independent of |R|, |S| — so
the bounds let the join ship and prune data without ever joining. All
functions take and return tensors on the index's device. Algorithm 1's
priority queue with early exit becomes one exact k-th order statistic
per row (the same θ, no queue).
"""
from __future__ import annotations

import numpy as np
import torch

from .metrics import pairwise_dist
from .types import SummaryTable

__all__ = ["pad_theta", "pivot_distance_matrix", "compute_theta",
           "theta_and_lb", "replication_lower_bounds",
           "group_lower_bounds", "hyperplane_distances", "ring_bounds"]

# float32 constants of the JAX package's pad (exactly representable, so
# a float32 tensor times them computes in float32 with the same factors)
_PAD_REL = float(np.float32(1.000004))
_PAD_ABS = float(np.float32(1e-6))


def pad_theta(th: torch.Tensor) -> torch.Tensor:
    """θ with a few-ulp safety margin, for *pruning comparisons only*.

    The quantities compared against θ (per-batch |q, p| distances, ring
    bounds, hyperplane distances) come out of different float32 graphs
    than θ itself; when true neighbors sit at distance *exactly* θ, a
    one-ulp discrepancy between two computations of the same real
    quantity could prune a true neighbor. Comparing against a θ padded
    by ~30 ulp relative + a tiny absolute term keeps every prune sound
    at negligible pruning-power cost. ±inf are fixed points.
    """
    return th * _PAD_REL + _PAD_ABS


def pivot_distance_matrix(pivots: torch.Tensor, metric: str = "l2"
                          ) -> torch.Tensor:
    """(M, M) true pivot-pivot distances |p_i, p_j| (float32; the L2 form
    is computed in float64 first)."""
    if metric != "l2":
        out = pairwise_dist(pivots, pivots, metric)
        out.fill_diagonal_(0.0)
        return out
    p = pivots.to(torch.float64)
    sq = (p * p).sum(-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (p @ p.T), min=0.0)
    out = torch.sqrt(d2)
    out.fill_diagonal_(0.0)
    return out.to(torch.float32)


def _check_candidates(t_s: SummaryTable, k: int) -> torch.Tensor:
    if t_s.knn_dists is None:
        raise ValueError("T_S must carry pivot-kNN distances")
    knn = t_s.knn_dists[:, :k].to(torch.float32)
    finite = int(torch.isfinite(knn).sum())
    if finite < k:
        raise ValueError(f"T_S holds {finite} finite candidates; need >= "
                         f"k={k} (is |S| >= k?)")
    return knn


def compute_theta(pivd: torch.Tensor, t_r: SummaryTable, t_s: SummaryTable,
                  k: int, *, block: int = 512) -> torch.Tensor:
    """θ_i for every R-partition (Eq. 6 / Algorithm 1): the k-th smallest
    U(P_i^R) + |p_i, p_j| + |p_j, s| over T_S's pivot-kNN lists (Thm 3).
    Empty R-partitions get θ_i = -inf. T_S keeps only the k nearest
    objects per S-partition — precisely the set the paper proves
    sufficient (text under Eq. 6)."""
    knn = _check_candidates(t_s, k)
    m_r = t_r.n_partitions
    theta = torch.full((m_r,), -float("inf"), device=pivd.device)
    occupied = t_r.counts > 0
    for lo in range(0, m_r, block):
        hi = min(lo + block, m_r)
        ub = (pivd[lo:hi][:, :, None] + knn[None, :, :]).reshape(hi - lo, -1)
        kth = torch.kthvalue(ub, k, dim=1).values
        theta[lo:hi] = torch.where(occupied[lo:hi], kth + t_r.upper[lo:hi],
                                   -float("inf"))
    return theta


def replication_lower_bounds(pivd: torch.Tensor, t_r: SummaryTable,
                             theta: torch.Tensor) -> torch.Tensor:
    """LB(P_j^S, P_i^R) of Corollary 2 / Algorithm 2, shape (M_s, M_r):
    s ∈ P_j^S ships to partition i iff |s, p_j| >= LB[j, i]. Empty
    R-partitions get +inf (never ship). Derived from the ulp-padded θ,
    so a neighbor at exactly LB survives the fp discrepancy between the
    assignment's |s, p_j| and this bound."""
    lb = pivd.T - t_r.upper[None, :] - pad_theta(theta)[None, :]
    lb = torch.where(torch.isfinite(theta)[None, :], lb, float("inf"))
    return torch.clamp(lb, min=0.0)


def theta_and_lb(pivd: torch.Tensor, t_r: SummaryTable, t_s: SummaryTable,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-batch bound math: (θ (M_r,), LB (M_s, M_r)) —
    :func:`compute_theta` + :func:`replication_lower_bounds`, the JAX
    package's fused ``theta_and_lb`` as device ops."""
    theta = compute_theta(pivd, t_r, t_s, k)
    return theta, replication_lower_bounds(pivd, t_r, theta)


def group_lower_bounds(lb: torch.Tensor, groups: torch.Tensor,
                       n_groups: int) -> torch.Tensor:
    """LB(P_j^S, G_g) = min_{i ∈ G_g} LB(P_j^S, P_i^R) (Theorem 6):
    ``lb`` (M_s, M_r), ``groups`` (M_r,) group id per R-partition →
    (M_s, n_groups)."""
    m_s = lb.shape[0]
    out = torch.full((n_groups, m_s), float("inf"), device=lb.device)
    idx = groups.to(torch.int64)[:, None].expand(-1, m_s)
    out.scatter_reduce_(0, idx, lb.T.contiguous(), reduce="amin")
    return out.T.contiguous()


def hyperplane_distances(query_to_pivots: torch.Tensor, pivd: torch.Tensor,
                         home: torch.Tensor) -> torch.Tensor:
    """d(q, HP(p_home, p_j)) = (|q,p_j|² − |q,p_home|²) / (2 |p_home, p_j|)
    for each query and pivot (Thm 1; Cor. 1 skips P_j for q when it
    exceeds θ). Computed in float64; the home column is +inf."""
    home = home.to(torch.int64)
    q2 = query_to_pivots.to(torch.float64) ** 2
    home_sq = torch.gather(q2, 1, home[:, None])
    d = (q2 - home_sq) / (2.0 * pivd[home]).to(torch.float64)
    d[torch.arange(home.shape[0], device=home.device), home] = float("inf")
    return d.to(torch.float32)


def ring_bounds(dist_to_pivot: torch.Tensor, theta: torch.Tensor,
                t_s: SummaryTable, s_part: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Theorem 2 interval per (query, S-partition) pair: s ∈ P_j^S can
    matter for q only if max{L(P_j^S), |p_j,q| − θ} <= |p_j, s| <=
    min{U(P_j^S), |p_j,q| + θ}. Returns (lo, hi), (n, len(s_part))."""
    dp = dist_to_pivot[:, s_part]
    lo = torch.maximum(t_s.lower[s_part][None, :], dp - theta[:, None])
    hi = torch.minimum(t_s.upper[s_part][None, :], dp + theta[:, None])
    return lo.to(torch.float32), hi.to(torch.float32)
