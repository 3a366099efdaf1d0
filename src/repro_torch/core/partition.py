"""Phase-1 of PGBJ: Voronoi assignment + summary tables (paper §4.2) —
PyTorch port of the JAX package's ``core.partition``.

Each object is mapped to its nearest pivot; per-partition statistics
(count, L, U and — for S — the k smallest object→pivot distances) are
aggregated into the summary table. On a CUDA tensor the L2 assignment
runs the hand-written kernel (``kernels.assign``, through
``kernels.ops``); on a CPU tensor its plain version, which is the JAX
package's ``_assign_blocked`` arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops
from .metrics import pairwise_dist
from .types import SummaryTable

__all__ = ["assign_to_pivots", "assign_and_summarize", "build_summary"]


def assign_to_pivots(
    data: torch.Tensor, pivots: torch.Tensor, *, block: int = 4096,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-pivot assignment: (part_ids int32 (n,), dists float32 (n,)).

    Tie-break: the lowest pivot index wins exact ties. The paper breaks
    ties toward the smaller partition; the join is correct under any
    deterministic tie-break (the bounds only use the *assigned*
    distance)."""
    if metric == "l2":
        return ops.assign(data, pivots)
    pid = torch.empty((data.shape[0],), dtype=torch.int32, device=data.device)
    dist = torch.empty((data.shape[0],), dtype=torch.float32,
                       device=data.device)
    for lo in range(0, data.shape[0], block):
        d = pairwise_dist(data[lo:lo + block], pivots, metric)
        dist[lo:lo + block], idx = d.min(dim=1)
        pid[lo:lo + block] = idx.to(torch.int32)
    return pid, dist


def lexsort_part_dist(part_ids: torch.Tensor, dists: torch.Tensor
                      ) -> torch.Tensor:
    """``np.lexsort((dists, part_ids))``: the stable (partition, distance)
    order, as int64 — two stable sorts."""
    order = torch.argsort(dists, stable=True)
    return order[torch.argsort(part_ids[order], stable=True)]


def _summarize(part_ids: torch.Tensor, dists: torch.Tensor, m: int,
               k: int | None, order: torch.Tensor) -> SummaryTable:
    dev = part_ids.device
    pid = part_ids.to(torch.int64)
    counts = torch.zeros((m,), dtype=torch.int32, device=dev).scatter_add_(
        0, pid, torch.ones_like(part_ids))
    lower = torch.full((m,), float("inf"), device=dev).scatter_reduce_(
        0, pid, dists, reduce="amin")
    upper = torch.zeros((m,), device=dev).scatter_reduce_(
        0, pid, dists, reduce="amax")
    knn = None
    if k is not None:
        # k smallest |s, p_j| per partition: the first k entries of each
        # partition's segment of the (partition, distance) order
        n = pid.shape[0]
        sp, sd = pid[order], dists[order]
        idx = torch.arange(n, device=dev)
        seg_start = torch.full((m,), n, dtype=torch.int64, device=dev)
        seg_start.scatter_reduce_(0, sp, idx, reduce="amin")
        rank = idx - seg_start[sp]
        # entries past rank k land in one trash slot past the table
        slot = torch.where(rank < k, sp * k + rank, m * k)
        knn = torch.full((m * k + 1,), float("inf"), device=dev)
        knn.scatter_(0, slot, sd)
        knn = knn[:m * k].reshape(m, k)
    return SummaryTable(counts=counts, lower=lower, upper=upper,
                        knn_dists=knn)


def build_summary(part_ids: torch.Tensor, dists: torch.Tensor, m: int,
                  k: int | None = None) -> SummaryTable:
    """T_R (``k=None``: counts, L and U per partition) or T_S (also the
    k smallest object→pivot distances per partition) from phase-1
    output."""
    order = None if k is None else lexsort_part_dist(part_ids, dists)
    return _summarize(part_ids, dists, m, k, order)


def assign_and_summarize(
    data: torch.Tensor, pivots: torch.Tensor, *, k: int | None = None,
    metric: str = "l2", return_order: bool = False,
):
    """Fused phase-1 for one dataset: (part_ids, dists, summary table),
    all tensors on ``data``'s device. ``return_order=True`` appends the
    packed-layout sort order (``lexsort((dists, part_ids))``, int64) as
    a fourth element."""
    m = pivots.shape[0]
    part_ids, dists = assign_to_pivots(data, pivots, metric=metric)
    order = lexsort_part_dist(part_ids, dists)
    table = _summarize(part_ids, dists, m, k, order)
    if return_order:
        return part_ids, dists, table, order
    return part_ids, dists, table
