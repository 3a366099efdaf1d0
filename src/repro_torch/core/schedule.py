"""Pruned tile schedules — the plan's bounds lowered to tile level.

PyTorch port of the device half of the JAX package's ``core.schedule``:
per-S-tile Thm-2 statistics (:func:`segment_tile_stats`), the Cor. 1 +
Thm 2 visit mask evaluated per (R tile, S tile) (:func:`visit_mask`),
and its prefix compaction into a dense ``(nr_tiles, T)`` int32 schedule
plus per-row counts (:func:`compact_visits`). The last two are device
ops with static shapes and no host sync (cumsum ranks + ``scatter_``),
so the megastep builds its schedule on the card between enqueue and
fetch. The scheduled gather kernel (`kernels.distance_topk`) walks the
result; pruned tiles are never read.

Tile-granular bound evaluation takes the loosest bound over a tile's
queries, so the scheduled candidate set is a superset of the per-query
Algorithm-3 set and the join stays exact. The host-planned schedule
(``build_tile_schedule``) comes with the host-planned slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .bounds import pad_theta

__all__ = ["segment_tile_stats", "visit_mask", "compact_visits"]


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
               present: torch.Tensor, *, bm: int) -> torch.Tensor:
    """Cor. 1 + Thm 2 for one segment, L2 — ``visit_mask_jnp`` of the
    JAX package as device ops.

    ``qp`` (B, M) true query→pivot distances, ``home`` (B,) int,
    ``th_q`` (B,) per-query kNN radius bound (−inf for padding rows),
    ``valid_q`` (B,) bool; ``sd_min``/``sd_max``/``present`` from
    :func:`segment_tile_stats`. B must be a multiple of ``bm``. Returns a
    (B // bm, ns_tiles) bool visit mask.
    """
    b, m = qp.shape
    nr_tiles = b // bm
    home_c = torch.clamp(home.to(torch.int64), 0, m - 1)
    # prune against the ulp-padded θ: qp and th_q come from different
    # fp graphs, and neighbors at exactly θ must survive
    thp = pad_theta(th_q)
    q2 = qp.to(torch.float32) ** 2
    home_sq = torch.gather(q2, 1, home_c[:, None])
    denom = torch.clamp(2.0 * pivd[home_c], min=1e-30)
    d_hp = (q2 - home_sq) / denom
    alive = d_hp <= thp[:, None]
    alive.scatter_(1, home_c[:, None], True)     # home column never pruned
    alive &= valid_q[:, None]

    alive_t = alive.reshape(nr_tiles, bm, m).any(dim=1)
    inf = torch.full_like(qp, float("inf"))
    lo_q = torch.where(alive, qp - thp[:, None], inf)
    hi_q = torch.where(alive, qp + thp[:, None], -inf)
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
