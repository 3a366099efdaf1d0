"""The reducer-side kNN join (paper Algorithm 3), tile-adapted — PyTorch
port of the JAX package's ``core.join``.

``join_group`` is the group executor: it consumes the split planner's
``(SIndex, QueryPlan)`` pair — replica selection slices the index's
pivot-sorted packing, so no per-group sort runs — and dispatches to one
of three engines, all exact, all torch ops on the index's device:

* ``join_group_dense`` — blocked brute force between R_g and the shipped
  S_g (correct because Cor. 2 guarantees S_g ⊇ KNN(r, S) for r ∈ R_g).
* ``join_group_pruned`` — Algorithm 3 with per-tile masking: per
  R-partition, S-partitions in ascending pivot distance (line 14),
  Cor. 1 skips whole partitions per query, Thm 2 masks candidates inside
  a tile, θ tightens between tiles (lines 18-24). A host loop, as in the
  reference.
* ``join_group_gather`` (L2) — the compacted schedule
  (`core.schedule.build_tile_schedule`) walked by the scheduled gather
  top-k: the hand-written CUDA kernel on the card, its plain version on
  the CPU (``kernels.ops.distance_topk_gather``), on rows centered by
  the index's mean. Other metrics walk the schedule with torch ops.

Each engine returns (dists, ids); ``core.api.execute_join`` keeps the
ids and reports canonical distances.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .bounds import pad_theta
from .certify import exact_d2, run_width, select_run
from .metrics import canonical_gathered, cmp_dist, from_cmp, select_dist
from .schedule import TileSchedule, schedule_for_group
from .types import JoinStats

__all__ = ["join_group", "join_group_dense", "join_group_pruned",
           "join_group_gather", "topk_merge"]

_INF = float("inf")


def topk_merge(best_d: torch.Tensor, best_i: torch.Tensor,
               new_d: torch.Tensor, new_i: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a running (nq, k) top-k with a (nq, t) tile; ascending by
    distance, ties keep the running entries first."""
    cat_d = torch.cat([best_d, new_d], dim=1)
    cat_i = torch.cat([best_i, new_i], dim=1)
    cat_d, order = torch.sort(cat_d, dim=1, stable=True)
    return cat_d[:, :k], torch.take_along_dim(cat_i, order[:, :k], dim=1)


def _empty_run(nq: int, k: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((nq, k), _INF, device=dev),
            torch.full((nq, k), -1, dtype=torch.int64, device=dev))


def join_group_dense(
    r: torch.Tensor, s: torch.Tensor, s_ids: torch.Tensor, k: int,
    *, tile_r: int = 128, tile_s: int = 512,
    stats: Optional[JoinStats] = None, metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact blocked brute-force top-k of each r over the shipped s."""
    nq, ns = r.shape[0], s.shape[0]
    if ns < k:
        raise ValueError(f"group received {ns} S objects < k={k}")
    out_d, out_i = _empty_run(nq, k, r.device)
    for qlo in range(0, nq, tile_r):
        bd, bi = _empty_run(min(tile_r, nq - qlo), k, r.device)
        for slo in range(0, ns, tile_s):
            d2 = select_dist(r[qlo:qlo + tile_r], s[slo:slo + tile_s],
                             metric)
            bd, bi = topk_merge(bd, bi, d2,
                                s_ids[slo:slo + tile_s].expand_as(d2), k)
        out_d[qlo:qlo + tile_r] = bd
        out_i[qlo:qlo + tile_r] = bi
    if stats is not None:
        tiles = -(-nq // tile_r) * -(-ns // tile_s)
        stats.pairs_computed += nq * ns
        stats.tiles_total += tiles
        stats.tiles_visited += tiles
    return from_cmp(out_d, metric), out_i


def _scheduled_pairs(sched: TileSchedule, nq: int, ns: int) -> int:
    """(query, row) pairs the schedule's live slots cover."""
    dev = sched.counts.device
    bm, bn = sched.bm, sched.bn
    q_rows = torch.clamp(nq - torch.arange(sched.nr_tiles, device=dev) * bm,
                         0, bm)
    s_rows = torch.clamp(ns - sched.schedule.to(torch.int64) * bn, 0, bn)
    live = (torch.arange(sched.schedule.shape[1], device=dev)[None, :]
            < sched.counts[:, None])
    return int((q_rows[:, None] * s_rows * live).sum())


def join_group_gather(
    r: torch.Tensor, s: torch.Tensor, s_ids: torch.Tensor, k: int,
    sched: TileSchedule, *, stats: Optional[JoinStats] = None,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk a compacted ``TileSchedule`` with torch ops — exact top-k
    over exactly the scheduled (R tile, S tile) pairs. ``s``/``s_ids``
    in the layout the schedule was built for. The metric-generic walk;
    L2 groups go through the scheduled gather kernel instead
    (:func:`join_group`)."""
    nq, ns = r.shape[0], s.shape[0]
    bm, bn = sched.bm, sched.bn
    out_d, out_i = _empty_run(nq, k, r.device)
    schedule = sched.schedule.cpu().tolist()
    counts = sched.counts.cpu().tolist()
    for t in range(sched.nr_tiles):
        qlo, qhi = t * bm, min((t + 1) * bm, nq)
        if qlo >= qhi:
            continue
        bd, bi = _empty_run(qhi - qlo, k, r.device)
        for j in schedule[t][:counts[t]]:
            slo, shi = j * bn, min((j + 1) * bn, ns)
            if slo >= shi:
                continue
            d2 = cmp_dist(r[qlo:qhi], s[slo:shi], metric)
            bd, bi = topk_merge(bd, bi, d2, s_ids[slo:shi].expand_as(d2), k)
        out_d[qlo:qhi] = from_cmp(bd, metric)
        out_i[qlo:qhi] = bi
    if stats is not None:
        stats.pairs_computed += _scheduled_pairs(sched, nq, ns)
        stats.tiles_total += sched.nr_tiles * sched.ns_tiles
        stats.tiles_visited += sched.n_visits
    return out_d, out_i


def join_group(g: int, r: torch.Tensor, r_sel: torch.Tensor, index, qplan,
               *, stats: Optional[JoinStats] = None):
    """One reducer group through the configured engine. The group's S
    replicas are sliced from the index's pivot-sorted packing (a masked
    subset of a sorted array is sorted). Returns (dists, ids, unc) rows
    aligned with ``r_sel``: ``unc`` flags the queries whose K-G run the
    gather reducer could not certify (``core.certify``; the caller
    re-runs them exactly), None for the other reducers."""
    cfg = qplan.config
    k = cfg.k
    mask = index.replica_mask_sorted(qplan.lb_group, g)
    if stats is not None:
        stats.replicas_s += int(mask.sum())
    ss = index.s_sorted[mask]
    sp = index.s_part_sorted[mask]
    sd = index.s_dist_sorted[mask]
    sids = index.s_ids_sorted[mask]
    reducer = cfg.resolved_reducer
    if reducer == "gather":
        return _join_group_gather_scheduled(r, r_sel, mask, ss, sp, sd, sids,
                                            index, qplan, stats)
    if reducer == "pruned":
        return join_group_pruned(
            r[r_sel], qplan.r_part[r_sel], ss, sp, sd, sids, index.pivots,
            index.pivd, qplan.theta, k, s_excess=index.s_excess,
            tile_s=cfg.tile_s, stats=stats, metric=cfg.metric) + (None,)
    return join_group_dense(r[r_sel], ss, sids, k, tile_r=cfg.tile_r,
                            tile_s=cfg.tile_s, stats=stats,
                            metric=cfg.metric) + (None,)


def _join_group_gather_scheduled(r, r_sel, mask, ss, sp, sd, sids, index,
                                 qplan, stats):
    """One group through the compacted schedule. Queries are sorted by
    home partition (the S side arrives pivot-sorted) so tiles are
    partition-coherent — what makes the tile-granular ring bounds
    bite. L2 groups run the scheduled gather top-k on rows centered by
    the index's mean (Forest-like values reach ~1000, where uncentered
    expanded d² loses true neighbors to cancellation noise)."""
    cfg = qplan.config
    k = cfg.k
    order_r = torch.argsort(qplan.r_part[r_sel], stable=True)
    rr = r[r_sel][order_r].contiguous()
    rp = qplan.r_part[r_sel][order_r]
    sched = schedule_for_group(index, qplan, rr, rp, sp, sd, stats=stats)
    unc = None
    if cfg.metric == "l2":
        gd, gi, unc = _gather_certified(rr, ss, sids, index.center(), k,
                                        sched, cfg)
        if stats is not None:
            stats.pairs_computed += _scheduled_pairs(sched, rr.shape[0],
                                                     ss.shape[0])
            stats.tiles_total += sched.nr_tiles * sched.ns_tiles
            stats.tiles_visited += sched.n_visits
    else:
        gd, gi = join_group_gather(rr, ss, sids, k, sched, stats=stats,
                                   metric=cfg.metric)
    inv = torch.argsort(order_r)
    return gd[inv], gi[inv], None if unc is None else unc[inv]


def _gather_certified(rr, ss, sids, center, k, sched, cfg):
    """K-G's run over the group's schedule on centered rows, its k in
    (exact d², id) order and the run's certificate (``core.certify``).
    Returns canonical (dists, ids, uncertified) — no host sync."""
    rc = (rr - center).contiguous()
    dk, pos = ops.distance_topk_gather(
        rc, (ss - center).contiguous(), run_width(k), sched.schedule,
        sched.counts, bm=cfg.tile_r, bn=cfg.tile_s)
    valid = pos >= 0
    pos_c = torch.clamp(pos.to(torch.int64), 0, max(ss.shape[0] - 1, 0))
    rows = ss[pos_c]
    inf = float("inf")
    return select_run(
        torch.where(valid, dk, inf),
        torch.where(valid, exact_d2(rr, rows), inf),
        torch.where(valid, sids[pos_c], -1),
        torch.where(valid, canonical_gathered(rr, rows), inf),
        torch.linalg.vector_norm(rc.to(torch.float64), dim=1), k,
        rr.shape[1])


def join_group_pruned(
    r: torch.Tensor, r_part: torch.Tensor, s: torch.Tensor,
    s_part: torch.Tensor, s_dist: torch.Tensor, s_ids: torch.Tensor,
    pivots: torch.Tensor, pivd: torch.Tensor, theta: torch.Tensor, k: int,
    *, s_excess: Optional[torch.Tensor] = None, tile_s: int = 512,
    stats: Optional[JoinStats] = None, metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 3 (lines 13-25), tile-masked. Returns (dists, ids) in
    the order of ``r``. Parameters mirror what a reducer holds: its R
    rows (+ home partitions), the shipped S rows (+ partitions, pivot
    distances, global ids) and the θ of its R partitions.

    ``s_excess`` (per pivot, float64;
    :func:`core.partition.assignment_excess`) widens Cor. 1 by how far a
    row may sit outside its pivot's Voronoi cell after the float32
    assignment (ROADMAP C15); ``None`` is the paper's exact cells. Under
    L2 |q, p_j| is taken in float64 and rounded once, as the shipped
    rows' |p_j, s| were at assignment. A ring is not clamped to the
    partition's [L, U]: every row of the partition lies in it."""
    nq = r.shape[0]
    dev = r.device
    out_d, out_i = _empty_run(nq, k, dev)
    if nq == 0:
        return out_d, out_i

    # organize shipped S by partition (the reducer's "parse S_i" — line 13)
    s_order = torch.argsort(s_part, stable=True)
    s, s_part = s[s_order], s_part[s_order]
    s_dist, s_ids = s_dist[s_order], s_ids[s_order]
    slack_h = (np.zeros((pivots.shape[0],)) if s_excess is None
               else s_excess.cpu().numpy())
    uniq_t, cnt_t = torch.unique_consecutive(s_part, return_counts=True)
    uniq_sp = uniq_t.cpu().numpy()
    sp_end = cnt_t.cumsum(0).cpu().numpy()
    sp_start = sp_end - cnt_t.cpu().numpy()
    uniq_idx = uniq_t.to(torch.int64)
    pivd_h = pivd.cpu().numpy()
    theta_h = theta.cpu().numpy()
    r_part64 = r_part.to(torch.int64)

    for pi in torch.unique(r_part64).cpu().tolist():
        q_sel = torch.nonzero(r_part64 == pi)[:, 0]
        q = r[q_sel]
        # line 14: visit S partitions ascending |p_i, p_j|
        order = pivd_h[pi, uniq_sp].argsort(kind="stable")
        th = torch.full((q.shape[0],), float(theta_h[pi]), device=dev)
        bd, bi = _empty_run(q.shape[0], k, dev)
        # |q, p_j| for the candidate partitions (Cor. 1 and Thm 2)
        qp = from_cmp(select_dist(q, pivots[uniq_idx], metric), metric)
        if stats is not None:
            stats.pivot_pairs_computed += qp.numel()
        d_home = from_cmp(select_dist(q, pivots[pi:pi + 1], metric),
                          metric)[:, 0]
        for jj in order.tolist():
            j = int(uniq_sp[jj])
            lo_j, hi_j = int(sp_start[jj]), int(sp_end[jj])
            # Corollary 1 per query (Euclidean only); θ ulp-padded
            thp = pad_theta(th)
            if j == pi or metric != "l2":
                alive = torch.ones((q.shape[0],), dtype=torch.bool,
                                   device=dev)
            else:
                denom = float(max(2.0 * pivd_h[pi, j], 1e-30))
                alive = ((qp[:, jj] ** 2 - d_home ** 2 - float(slack_h[j]))
                         / denom <= thp)
            if not bool(alive.any()):
                if stats is not None:
                    stats.tiles_total += -(-(hi_j - lo_j) // tile_s)
                continue
            # Theorem 2 interval for this partition
            ring_lo, ring_hi = qp[:, jj] - thp, qp[:, jj] + thp
            for slo in range(lo_j, hi_j, tile_s):
                shi = min(slo + tile_s, hi_j)
                if stats is not None:
                    stats.tiles_total += 1
                sd = s_dist[slo:shi]
                mask = (alive[:, None] & (sd[None, :] >= ring_lo[:, None])
                        & (sd[None, :] <= ring_hi[:, None]))
                n_pairs = int(mask.sum())
                if not n_pairs:
                    continue
                if stats is not None:
                    stats.tiles_visited += 1
                    stats.pairs_computed += n_pairs
                d2 = torch.where(mask, select_dist(q, s[slo:shi], metric),
                                 _INF)
                bd, bi = topk_merge(bd, bi, d2,
                                    s_ids[slo:shi].expand_as(d2), k)
                # θ tightens between tiles (block analogue of lines 22-24)
                th = torch.minimum(th, from_cmp(bd[:, k - 1], metric))
                thp = pad_theta(th)
                ring_lo, ring_hi = qp[:, jj] - thp, qp[:, jj] + thp
        out_d[q_sel] = from_cmp(bd, metric)
        out_i[q_sel] = bi
    return out_d, out_i
