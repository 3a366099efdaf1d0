"""Phase-1 of PGBJ: Voronoi assignment + summary tables (paper §4.2) —
PyTorch port of the JAX package's ``core.partition``.

Each object is mapped to its nearest pivot; per-partition statistics
(count, L, U and — for S — the k smallest object→pivot distances) are
aggregated into the summary table. On a CUDA tensor the L2 assignment
runs the hand-written kernel (``kernels.assign``, through
``kernels.ops``); on a CPU tensor its plain version, which is the JAX
package's ``_assign_blocked`` arithmetic.

Under L2 the kernel's float32 ‖x‖² + ‖p‖² − 2x·p is off by ~u·‖x‖², which
on map coordinates exceeds a small distance many times over (ROADMAP
C15). Every bound of PGBJ reads the distance to the *assigned* pivot
(θ through U and T_S, Cor. 2's replication, Thm 2's ring), so that
distance is taken again in float64 from the row's difference to its
pivot and rounded once: within half an ulp, which ``pad_theta`` covers.
Cor. 1 also assumes that each row lies in its pivot's Voronoi cell,
which the float32 choice can miss near a boundary;
:func:`assignment_excess` measures by how much, per partition.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops
from .metrics import pairwise_dist, sq_dist64
from .types import SummaryTable

__all__ = ["assign_to_pivots", "assign_and_summarize", "build_summary",
           "own_pivot_dist", "assignment_excess"]


def assign_to_pivots(
    data: torch.Tensor, pivots: torch.Tensor, *, block: int = 4096,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-pivot assignment: (part_ids int32 (n,), dists float32 (n,)).

    Tie-break: the lowest pivot index wins exact ties. The paper breaks
    ties toward the smaller partition; the join is correct under any
    deterministic tie-break (the bounds only use the *assigned*
    distance). Under L2 the ids are the kernel's and the distances
    :func:`own_pivot_dist`'s."""
    if metric == "l2":
        pid, _ = ops.assign(data, pivots)
        return pid, own_pivot_dist(data, pivots, pid)
    pid = torch.empty((data.shape[0],), dtype=torch.int32, device=data.device)
    dist = torch.empty((data.shape[0],), dtype=torch.float32,
                       device=data.device)
    for lo in range(0, data.shape[0], block):
        d = pairwise_dist(data[lo:lo + block], pivots, metric)
        dist[lo:lo + block], idx = d.min(dim=1)
        pid[lo:lo + block] = idx.to(torch.int32)
    return pid, dist


def own_pivot_dist(data: torch.Tensor, pivots: torch.Tensor,
                   part_ids: torch.Tensor, *, block: int = 65536
                   ) -> torch.Tensor:
    """Each row's L2 distance to its assigned pivot, float32 (n,): the
    difference, its squares summed and the √ taken in float64, rounded
    once."""
    out = torch.empty((data.shape[0],), dtype=torch.float32,
                      device=data.device)
    pid = part_ids.to(torch.int64)
    for lo in range(0, data.shape[0], block):
        diff = (data[lo:lo + block].to(torch.float64)
                - pivots[pid[lo:lo + block]].to(torch.float64))
        out[lo:lo + block] = torch.sqrt((diff * diff).sum(1)).to(
            torch.float32)
    return out


def assignment_excess(data: torch.Tensor, pivots: torch.Tensor,
                      part_ids: torch.Tensor, *, block: int = 65536
                      ) -> torch.Tensor:
    """Per pivot j, the largest |s, p_j|² − min_l |s, p_l|² over the rows
    assigned to j, float64 (M,): 0 where every row of P_j lies in p_j's
    Voronoi cell. A row of P_j lies within excess_j / (2 |p_i, p_j|) on
    p_i's side of HP(p_i, p_j) at most, so Cor. 1 holds with
    |q,p_j|² − |q,p_i|² − excess_j in place of |q,p_j|² − |q,p_i|²."""
    out = torch.zeros((pivots.shape[0],), dtype=torch.float64,
                      device=data.device)
    pid = part_ids.to(torch.int64)
    for lo in range(0, data.shape[0], block):
        d2 = sq_dist64(data[lo:lo + block], pivots)
        own = d2.gather(1, pid[lo:lo + block, None])[:, 0]
        out.scatter_reduce_(0, pid[lo:lo + block], own - d2.min(1).values,
                            "amax")
    return out


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
