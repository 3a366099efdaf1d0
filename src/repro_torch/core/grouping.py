"""Partition grouping strategies (paper §5) and the replication cost model
— the JAX package's ``core.grouping``, kept on numpy.

Both strategies pack the M R-partitions into N groups (N = reducer
count). Geometric grouping (Algorithm 4) is distance-driven and
load-balanced; greedy grouping grows each group by the partition that
minimizes the *replication increment* RP(S, G ∪ {P}) − RP(S, G) under
the Eq. 12 whole-partition approximation. These are O(M²) host scalar
loops with data-dependent control flow: :func:`group_partitions` takes
the planner's tensors, moves them to numpy once and returns an int32
numpy array.

Cost model: RP(S) (Theorem 7) — :func:`replication_count_exact` from
phase-1 output, :func:`replication_count_partitions` the Eq. 12
partition-level approximation the greedy strategy uses.
"""
from __future__ import annotations

import numpy as np

from .types import SummaryTable

__all__ = [
    "geometric_grouping",
    "greedy_grouping",
    "group_partitions",
    "replication_count_exact",
    "replication_count_partitions",
]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _seed_groups(pivd: np.ndarray, n_groups: int) -> list[int]:
    """Algorithm 4 lines 1-5: spread the N seed pivots far apart."""
    first = int(np.argmax(pivd.sum(axis=1)))
    seeds = [first]
    acc = pivd[first].copy()
    for _ in range(1, n_groups):
        acc[seeds] = -np.inf
        nxt = int(np.argmax(acc))
        seeds.append(nxt)
        acc = np.where(np.isneginf(acc), acc, acc + pivd[nxt])
    return seeds


def geometric_grouping(pivd: np.ndarray, counts: np.ndarray,
                       n_groups: int) -> np.ndarray:
    """Algorithm 4. Returns (M,) int32 group id per R-partition.

    Iteratively gives the currently-smallest group (by object
    population, the paper's load-balancing device) its nearest
    unassigned pivot.
    """
    m = pivd.shape[0]
    if n_groups > m:
        raise ValueError(f"n_groups={n_groups} > n_pivots={m}")
    groups = np.full((m,), -1, np.int64)
    seeds = _seed_groups(pivd, n_groups)
    group_sizes = np.zeros((n_groups,), np.int64)
    # running sum of distance from each pivot to each group's member pivots
    dist_to_group = np.zeros((n_groups, m), np.float64)
    for g, s in enumerate(seeds):
        groups[s] = g
        group_sizes[g] += int(counts[s])
        dist_to_group[g] = pivd[s]
    unassigned = groups < 0
    while unassigned.any():
        g = int(np.argmin(group_sizes))
        cand = np.where(unassigned, dist_to_group[g], np.inf)
        p = int(np.argmin(cand))
        groups[p] = g
        group_sizes[g] += int(counts[p])
        dist_to_group[g] += pivd[p]
        unassigned[p] = False
    return groups.astype(np.int32)


def replication_count_partitions(lb_group: np.ndarray,
                                 t_s: SummaryTable) -> np.ndarray:
    """Eq. 12 approximation: per group, count of S objects in partitions
    whose replication window is non-empty (whole partition counted).
    ``lb_group`` (M_s, n_groups). Returns (n_groups,) int64."""
    lb_group = _np(lb_group)
    upper, counts = _np(t_s.upper), _np(t_s.counts)
    hit = lb_group <= upper[:, None]
    hit &= (counts > 0)[:, None]
    return (hit * counts[:, None].astype(np.int64)).sum(axis=0)


def replication_count_exact(lb_group: np.ndarray, s_part: np.ndarray,
                            s_dist: np.ndarray) -> np.ndarray:
    """Theorem 7 exactly: |{s : |s,p_j| >= LB(P_j^S, G_g)}| per group."""
    lb_group, s_part, s_dist = _np(lb_group), _np(s_part), _np(s_dist)
    thr = lb_group[s_part]                               # (n_s, G)
    return (s_dist[:, None] >= thr).sum(axis=0).astype(np.int64)


def greedy_grouping(pivd: np.ndarray, counts: np.ndarray, n_groups: int,
                    lb: np.ndarray, t_s: SummaryTable) -> np.ndarray:
    """§5.2.2 greedy grouping under the Eq. 12 approximation.

    Seeds like Algorithm 4, then repeatedly extends the smallest group
    with the unassigned partition whose addition brings in the fewest
    *new* S objects (whole-partition granularity). ``lb`` (M_s, M_r)
    per-partition replication bounds (Cor. 2).
    """
    m = pivd.shape[0]
    if n_groups > m:
        raise ValueError(f"n_groups={n_groups} > n_pivots={m}")
    groups = np.full((m,), -1, np.int64)
    seeds = _seed_groups(pivd, n_groups)
    group_sizes = np.zeros((n_groups,), np.int64)
    # member[g, j] — is S-partition j already replicated to group g?
    member = np.zeros((n_groups, lb.shape[0]), bool)
    s_counts_raw = _np(t_s.counts)
    s_counts = s_counts_raw.astype(np.int64)
    hit = lb <= _np(t_s.upper)[:, None]                  # (M_s, M_r): adding
    hit &= (s_counts_raw > 0)[:, None]                   # partition i pulls j
    for g, s in enumerate(seeds):
        groups[s] = g
        group_sizes[g] += int(counts[s])
        member[g] = hit[:, s]
    unassigned = groups < 0
    while unassigned.any():
        g = int(np.argmin(group_sizes))
        # replication increment of adding partition i to group g
        new = hit & ~member[g][:, None]                  # (M_s, M_r)
        inc = (new * s_counts[:, None]).sum(axis=0)      # (M_r,)
        inc = np.where(unassigned, inc, np.iinfo(np.int64).max)
        p = int(np.argmin(inc))
        groups[p] = g
        group_sizes[g] += int(counts[p])
        member[g] |= hit[:, p]
        unassigned[p] = False
    return groups.astype(np.int32)


def group_partitions(strategy: str, pivd, t_r: SummaryTable, n_groups: int,
                     *, lb=None, t_s: SummaryTable | None = None
                     ) -> np.ndarray:
    """Dispatch on the configured strategy ('none' = partition i goes to
    group i mod n_groups, the ungrouped §4 algorithm when n_groups ==
    M). Tensors or arrays in; (M,) int32 numpy out."""
    if strategy == "none":
        return np.arange(t_r.n_partitions, dtype=np.int32) % n_groups
    pivd, counts = _np(pivd), _np(t_r.counts)
    if strategy == "geometric":
        return geometric_grouping(pivd, counts, n_groups)
    if strategy == "greedy":
        if lb is None or t_s is None:
            raise ValueError("greedy grouping needs lb and t_s")
        return greedy_grouping(pivd, counts, n_groups, _np(lb), t_s)
    raise ValueError(f"unknown grouping {strategy!r}")
