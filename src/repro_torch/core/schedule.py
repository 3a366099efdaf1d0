"""Pruned tile schedules — the plan's bounds lowered to tile level.

PyTorch port of the device half of the JAX package's ``core.schedule``:
per-S-tile Thm-2 statistics (:func:`segment_tile_stats`), the Cor. 1 +
Thm 2 visit mask evaluated per (R tile, S tile) (:func:`visit_mask`),
and its prefix compaction into a dense ``(nr_tiles, T)`` int32 schedule
plus per-row counts (:func:`compact_visits`). The last two are device
ops with static shapes and no host sync (cumsum ranks + ``scatter_``),
so the megastep builds its schedule on the card between enqueue and
fetch. The host-planned path builds its per-group schedule with
:func:`build_tile_schedule` (Cor. 1 + Thm 2 per query, θ tightened per
query from T_S's pivot-kNN lists) and compacts it with
:func:`compact_visit_mask` into a :class:`TileSchedule`. The scheduled
gather kernel (`kernels.distance_topk`) walks either result; pruned
tiles are never read.

Tile-granular bound evaluation takes the loosest bound over a tile's
queries, so the scheduled candidate set is a superset of the per-query
Algorithm-3 set and the join stays exact. Rows with ``part < 0`` are
padding on either side.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .bounds import pad_theta
from .metrics import cmp_dist, from_cmp, sq_dist64
from .types import JoinStats

__all__ = ["segment_tile_stats", "visit_mask", "compact_visits",
           "TileSchedule", "build_tile_schedule", "compact_visit_mask",
           "schedule_for_group"]


def segment_tile_stats(
    s_part_sorted: torch.Tensor, s_dist_sorted: torch.Tensor, m: int,
    bn: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-S-tile Thm-2 statistics of a packed S layout.

    Returns ``(sd_min, sd_max, present)`` of shape (ns_tiles, M): the
    min/max ``|p_j, s|`` over each tile's rows of partition j and whether
    partition j has any row in the tile. Query-independent: computed
    once per index and tile size.
    """
    dev = s_part_sorted.device
    n_s = int(s_part_sorted.shape[0])
    ns_tiles = max(1, -(-n_s // bn))
    valid = s_part_sorted >= 0
    tile = torch.arange(n_s, device=dev) // bn
    flat = (tile * m + s_part_sorted.to(torch.int64))[valid]
    vals = s_dist_sorted.to(torch.float32)[valid]
    sd_min = torch.full((ns_tiles * m,), float("inf"), device=dev)
    sd_max = torch.full((ns_tiles * m,), -float("inf"), device=dev)
    sd_min.scatter_reduce_(0, flat, vals, reduce="amin")
    sd_max.scatter_reduce_(0, flat, vals, reduce="amax")
    sd_min = sd_min.reshape(ns_tiles, m)
    sd_max = sd_max.reshape(ns_tiles, m)
    return sd_min, sd_max, sd_max > -float("inf")


def visit_mask(qp: torch.Tensor, home: torch.Tensor, th_q: torch.Tensor,
               valid_q: torch.Tensor, pivd: torch.Tensor,
               sd_min: torch.Tensor, sd_max: torch.Tensor,
               present: torch.Tensor, excess: torch.Tensor, *,
               bm: int) -> torch.Tensor:
    """Cor. 1 + Thm 2 for one segment, L2 — ``visit_mask_jnp`` of the
    JAX package as device ops, made sound (ROADMAP C15): a superset of
    the JAX mask on the same inputs.

    ``qp`` (B, M) true query→pivot distances, ``home`` (B,) int,
    ``th_q`` (B,) per-query kNN radius bound (−inf for padding rows),
    ``valid_q`` (B,) bool; ``sd_min``/``sd_max``/``present`` from
    :func:`segment_tile_stats`; ``excess`` (M,) float64, the segment's
    assignment excess (``core.partition.assignment_excess``; zeros for
    an index carried across without one). B must be a multiple of
    ``bm``. Returns a (B // bm, ns_tiles) bool visit mask.

    Cor. 1 is tested in float64 on ``qp``, widened by the excess and by
    the float32 rounding of ``pivd``; the Thm 2 ring is widened by the
    float32 rounding of the tile stats.
    """
    b, m = qp.shape
    nr_tiles = b // bm
    home_c = torch.clamp(home.to(torch.int64), 0, m - 1)
    # prune against the ulp-padded θ: qp and th_q come from different
    # fp graphs, and neighbors at exactly θ must survive
    qp = qp.to(torch.float64)
    thp = pad_theta(th_q).to(torch.float64)
    q2 = qp ** 2 - excess.to(torch.float64)[None, :]
    denom = torch.clamp(2.0 * pivd[home_c].to(torch.float64)
                        * (1.0 + 2.0 ** -20), min=1e-30)
    slack = (qp + thp[:, None]) * 2.0 ** -22
    home_sq = torch.gather(qp ** 2, 1, home_c[:, None])
    d_hp = (q2 - home_sq) / denom
    alive = d_hp <= thp[:, None]
    alive.scatter_(1, home_c[:, None], True)     # home column never pruned
    alive &= valid_q[:, None]

    alive_t = alive.reshape(nr_tiles, bm, m).any(dim=1)
    inf = torch.full_like(qp, float("inf"))
    lo_q = torch.where(alive, qp - thp[:, None] - slack, inf)
    hi_q = torch.where(alive, qp + thp[:, None] + slack, -inf)
    lo_t = lo_q.reshape(nr_tiles, bm, m).amin(dim=1)
    hi_t = hi_q.reshape(nr_tiles, bm, m).amax(dim=1)

    overlap = (alive_t[:, None, :] & present[None, :, :]
               & (sd_max[None, :, :] >= lo_t[:, None, :])
               & (sd_min[None, :, :] <= hi_t[:, None, :]))
    return overlap.any(dim=2)


def compact_visits(visit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nr_tiles, T) bool → prefix-compacted (schedule int32, counts int32)
    — ``compact_visits_jnp`` of the JAX package: cumulative-sum ranks
    along the tile axis plus one flat scatter, all static shapes.

    Rows with zero visits get one fallback visit of tile 0 so every R
    tile's output flush runs. Visited tiles come out ascending. Padding
    slots repeat the row's last valid entry; the gather kernel treats
    every slot at or past ``counts[i]`` as dead all the same.
    """
    nr_tiles, t = visit.shape
    dev = visit.device
    visit = visit.clone()
    visit[:, 0] |= ~visit.any(dim=1)
    counts = visit.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(visit.to(torch.int64), dim=1) - 1
    # flat scatter into one spare trash column for unvisited tiles
    pos = torch.where(visit, rank, torch.full_like(rank, t))
    tile = torch.arange(t, dtype=torch.int32, device=dev).expand(nr_tiles, t)
    sched = torch.zeros((nr_tiles, t + 1), dtype=torch.int32, device=dev)
    sched.scatter_(1, pos, tile)
    sched = sched[:, :t]
    last = torch.gather(sched, 1, (counts.to(torch.int64) - 1)[:, None])
    slot = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    sched = torch.where(slot < counts[:, None], sched, last)
    return sched.contiguous(), counts


@dataclasses.dataclass
class TileSchedule:
    """Compacted per-R-tile visit list over S tiles (tensors)."""

    schedule: torch.Tensor    # (nr_tiles, max_visits) int32, pad = last entry
    counts: torch.Tensor      # (nr_tiles,) int32, >= 1
    visit_mask: torch.Tensor  # (nr_tiles, ns_tiles) bool — the dense view
    bm: int
    bn: int

    @property
    def nr_tiles(self) -> int:
        return int(self.visit_mask.shape[0])

    @property
    def ns_tiles(self) -> int:
        return int(self.visit_mask.shape[1])

    @property
    def n_visits(self) -> int:
        """Total scheduled (R tile, S tile) steps."""
        return int(self.counts.sum())

    @property
    def density(self) -> float:
        """Visited fraction of the dense grid (1.0 = no pruning)."""
        total = self.nr_tiles * self.ns_tiles
        return self.n_visits / total if total else 0.0


def compact_visit_mask(visit: torch.Tensor, *,
                       max_visits: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nr_tiles, ns_tiles) bool → (schedule int32, counts int32),
    ascending per row. Every row must have at least one visited tile;
    padding slots repeat the row's last valid entry."""
    counts = visit.sum(dim=1, dtype=torch.int32)
    if bool((counts == 0).any()):
        raise ValueError("visit mask has empty rows; add a fallback tile")
    widest = int(counts.max())
    width = widest if max_visits is None else int(max_visits)
    if width < widest:
        raise ValueError(f"max_visits={width} < widest row {widest}")
    # a stable sort of ~visit puts the visited tile indices first,
    # ascending; slots past a row's count re-select its last entry
    order = torch.argsort((~visit).to(torch.int8), dim=1, stable=True)
    slot = torch.minimum(
        torch.arange(width, device=visit.device)[None, :],
        (counts.to(torch.int64) - 1)[:, None])
    schedule = torch.gather(order, 1, slot).to(torch.int32)
    return schedule.contiguous(), counts


def build_tile_schedule(
    r: torch.Tensor, r_part: torch.Tensor, s_part: torch.Tensor,
    s_dist: torch.Tensor, pivots: torch.Tensor, pivd: torch.Tensor,
    theta: torch.Tensor, *, bm: int, bn: int, metric: str = "l2",
    knn_dists: Optional[torch.Tensor] = None, k: Optional[int] = None,
    stats: Optional[JoinStats] = None, theta_block: int = 8192,
    tile_block: int = 64, s_excess: Optional[torch.Tensor] = None,
) -> TileSchedule:
    """Lower Cor. 1 + Thm 2 to an (R tile × S tile) visit schedule.

    ``r``/``r_part`` are the reducer's queries in their kernel layout;
    ``s_part``/``s_dist`` the S rows in theirs (pivot-sorted for tight
    tiles; any layout is correct). With T_S's pivot-kNN lists
    (``knn_dists`` + ``k``) θ is tightened per query to the k-th
    smallest ``|q,p_j| + p_j.d_i`` — Thm 3 at the query, a sound
    radius bound computable before any join. ``tile_block`` R tiles are
    intersected with all S tiles at a time (bounded memory).

    Under L2 the schedule is :func:`visit_mask`'s sound form: |q, p_j|
    in float64, θ rounded up, Cor. 1 widened by ``s_excess`` (the
    index's assignment excess; None: zeros) and the rounding of
    ``pivd``, the rings by the rounding of the tile stats (ROADMAP C15).
    """
    dev = r.device
    n_r, n_s = r_part.shape[0], s_part.shape[0]
    m = pivots.shape[0]
    nr_tiles = max(1, -(-n_r // bm))
    inf = float("inf")

    valid_q = r_part >= 0
    home = torch.clamp(r_part.to(torch.int64), 0, m - 1)
    th_q = torch.where(valid_q, theta[home], -inf)

    # |q, p_j| for every pivot — the job-2 mapper's pivot distances
    l2 = metric == "l2"
    if l2:
        qp = torch.sqrt(sq_dist64(r, pivots))                # float64
    else:
        qp = from_cmp(cmp_dist(r, pivots, metric), metric)  # (n_r, M)
    if stats is not None:
        stats.pivot_pairs_computed += int(valid_q.sum()) * m

    kk = 0 if knn_dists is None or k is None else min(k, knn_dists.shape[1])
    if kk and m * kk >= k:
        knn = knn_dists[:, :kk]
        knn = torch.where(torch.isfinite(knn), knn, inf)
        for lo in range(0, n_r, theta_block):
            hi = min(lo + theta_block, n_r)
            ub = (qp[lo:hi, :, None] + knn[None, :, :]).reshape(hi - lo, -1)
            kth = torch.kthvalue(ub, k, dim=1).values
            if l2:                                  # rounded up
                k32 = kth.to(torch.float32)
                kth = torch.where(k32.to(torch.float64) < kth, torch.nextafter(
                    k32, torch.full_like(k32, inf)), k32)
            th_q[lo:hi] = torch.where(valid_q[lo:hi],
                                      torch.minimum(th_q[lo:hi], kth), -inf)

    # Cor. 1 per (query, partition); home column never pruned. All θ
    # comparisons use the ulp-padded θ so neighbors at exactly θ survive
    # fp discrepancies between the qp and θ graphs
    thp = pad_theta(th_q)
    slack = 0.0
    if l2:
        excess = (torch.zeros((m,), dtype=torch.float64, device=dev)
                  if s_excess is None else s_excess.to(torch.float64))
        q2 = qp ** 2
        home_sq = torch.gather(q2, 1, home[:, None])
        denom = torch.clamp(2.0 * pivd[home].to(torch.float64)
                            * (1.0 + 2.0 ** -20), min=1e-30)
        thp = thp.to(torch.float64)
        slack = (qp + thp[:, None]) * 2.0 ** -22
        alive = (q2 - excess[None, :] - home_sq) / denom <= thp[:, None]
    else:
        alive = torch.ones((n_r, m), dtype=torch.bool, device=dev)
    alive[torch.arange(n_r, device=dev), home] = True
    alive &= valid_q[:, None]

    # reduce to R-tile granularity: any-alive, loosest ring per partition
    tile_of_r = (torch.arange(n_r, device=dev) // bm)[:, None].expand(-1, m)
    alive_t = torch.zeros((nr_tiles, m), dtype=torch.int32, device=dev)
    alive_t = alive_t.scatter_add_(0, tile_of_r, alive.to(torch.int32)) > 0
    lo_q = torch.where(alive, qp - thp[:, None] - slack, inf)
    hi_q = torch.where(alive, qp + thp[:, None] + slack, -inf)
    lo_t = torch.full((nr_tiles, m), inf, device=dev,
                      dtype=lo_q.dtype).scatter_reduce_(
        0, tile_of_r, lo_q, reduce="amin")
    hi_t = torch.full((nr_tiles, m), -inf, device=dev,
                      dtype=hi_q.dtype).scatter_reduce_(
        0, tile_of_r, hi_q, reduce="amax")

    # S-tile × partition |p_j, s| ranges (Thm 2's L/U at tile resolution)
    sd_min, sd_max, present = segment_tile_stats(s_part, s_dist, m, bn)

    # visit[t, u] = ∃ partition j present in u with ring overlap
    visit = torch.cat([
        (alive_t[a:a + tile_block, None, :] & present[None, :, :]
         & (sd_max[None, :, :] >= lo_t[a:a + tile_block, None, :])
         & (sd_min[None, :, :] <= hi_t[a:a + tile_block, None, :])
         ).any(dim=2)
        for a in range(0, nr_tiles, tile_block)])

    # fallback: an R tile with no visit (all-padding, or everything
    # pruned) gets one visit of the first non-empty S tile, so every R
    # tile's output flush runs
    any_s = present.any(dim=1)
    fallback = int(torch.argmax(any_s.to(torch.int8))) if bool(
        any_s.any()) else 0
    empty = ~visit.any(dim=1)
    visit[empty, fallback] = True
    schedule, counts = compact_visit_mask(visit)
    return TileSchedule(schedule=schedule, counts=counts, visit_mask=visit,
                        bm=bm, bn=bn)


def schedule_for_group(index, qplan, rr: torch.Tensor, rp: torch.Tensor,
                       sp: torch.Tensor, sd: torch.Tensor, *,
                       stats: Optional[JoinStats] = None) -> TileSchedule:
    """:func:`build_tile_schedule` driven by the split planner: the
    ``SIndex`` supplies the geometry (pivots, ``pivd``, T_S pivot-kNN
    lists), the ``QueryPlan`` θ and the tile sizes. ``rr``/``rp`` are
    the group's queries in kernel layout; ``sp``/``sd`` its S replicas
    (pivot-sorted by the index packing)."""
    cfg = qplan.config
    return build_tile_schedule(
        rr, rp, sp, sd, index.pivots, index.pivd, qplan.theta,
        bm=cfg.tile_r, bn=cfg.tile_s, metric=cfg.metric,
        knn_dists=index.t_s.knn_dists, k=cfg.k, stats=stats,
        s_excess=index.s_excess)
