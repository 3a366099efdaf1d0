"""Distance bounds of PGBJ (paper §4.3) — the part of the JAX package's
``core.bounds`` that the megastep path needs. ``theta_and_lb`` and the
replication / grouping bounds come with the host-planned slice (ROADMAP
Queue A)."""
from __future__ import annotations

import numpy as np
import torch

from .metrics import pairwise_dist

__all__ = ["pad_theta", "pivot_distance_matrix"]

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
