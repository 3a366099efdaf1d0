"""Fused device-resident query megastep — PyTorch port of the JAX
package's ``core.megastep``, over a static ``SIndex`` or a
``MutableIndex`` (every live segment, the write buffer included).

Per R micro-batch, with no host round trip between the upload of the
queries and the fetch of the result, five stages run on the device:

1. **assign** — query→pivot distances + home partitions against every
   segment's pivots, in coordinates centered on one shared center (the
   mean of every non-padding row, tombstoned ones included);
2. **bounds** — a per-query kNN radius θ over the union of all segments'
   T_S pivot-kNN lists: the (k + dead)-th smallest Thm-3 upper bound
   |q, p_j| + p_j.d_l, widened by the tombstone count so masking dead
   rows can never starve the top-k (+inf — visit everything — when the
   order statistic falls outside the ``w_cap`` smallest bounds);
3. **schedule** — Cor. 1 / Thm 2 per (R tile, S tile) for each segment
   (``core.schedule.visit_mask``), concatenated over the segments' tile
   ranges and prefix-compacted with cumsum ranks + one scatter
   (``compact_visits``);
4. **gather top-k** — one launch of the hand-written CUDA kernel
   (``kernels.distance_topk``, K-G) over the whole concatenated schedule
   on the card, its plain version on the CPU: each R tile walks its
   scheduled S tiles and keeps an ascending kp-run (kp = the next power
   of two past k, ``certify.run_width``) of d² in **centered**
   coordinates, tombstoned and padding rows masked
   by ``alive`` before selection;
5. **merge** — the run's rows' exact float64 d² and canonical
   distances from the raw rows, int64 global ids, the first k in
   (exact d², id) order reported in (canonical distance, id) order, the
   run's certificate (``core.certify``; ``finalize`` re-runs the
   queries it cannot certify), and optionally an id-dedup merge with a
   carried state.

Both the kernel and its plain version select on centered rows (the
payload keeps a centered copy): forest-like values reach ~1000, where
the ‖x‖²·eps cancellation noise of the expanded d² would be real.

The payload is keyed on the index version: a mutation (insert, seal,
delete, compact) makes the next batch rebuild it — per-segment pieces
are cached by segment identity, so only the concatenation and the
liveness mask are redone — under ``refresh_lock``, which an owner that
mutates concurrently (``serve.Datastore``) points at its own lock.
Ragged batches are padded to power-of-two buckets. The steady-state
call (:meth:`MegastepEngine.join_batch_device`) makes no host sync:
every value it branches on (θ's order-statistic index, the tombstone
count, the segment metadata) is host-side.

Exactness: the scheduled candidate set is a superset of the true live
top-k (θ is a sound union-level radius bound, Cor. 1 and Thm 2 tested in
float64 with the assignment excess), a certified run holds every row
the exact order would put in the k and an uncertified one re-runs
exactly, and the reported distances are the canonical per-pair values —
so a query's result, ids at ties included, depends only on (query row,
live rows), for any batch split, segmentation, shard count and device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..kernels import ops
from ..kernels.sorted_merge import merge_sorted_runs_unique, next_pow2
from ..serve import faultinject
from .certify import exact_d2, exact_topk, run_width, select_run
from .metrics import canonical_gathered
from .schedule import compact_visits, visit_mask
from .types import JoinConfig, JoinStats

__all__ = ["MegastepEngine", "JoinHandle", "StepOut",
           "assign_bounds_schedule", "assign_theta", "schedule_visits",
           "canonical_run", "rerun_scheduled"]


class StepOut(NamedTuple):
    """What every engine's ``join_batch_device`` returns, on the device.

    ``d`` (B, k) float32 canonical distances and ``ids`` (B, k) int64
    global ids, ascending; ``lm`` (B,) float32, a lower bound on the
    distance of every row the step excluded (+inf where it excluded
    nothing: the fp32 megastep, a fully served mesh; the int8 tier's
    certification bound); ``uncertified`` (B,) bool, the queries whose
    K-G run the caller must re-run exactly (``certify``; all False in
    int8 mode, which certifies with ``lm``)."""

    d: torch.Tensor
    ids: torch.Tensor
    lm: torch.Tensor
    uncertified: torch.Tensor


@dataclasses.dataclass
class _SegGeom:
    """One segment's query-independent geometry, on the device."""

    pivots_c: torch.Tensor   # (M, dim) pivots minus the shared center
    pivd: torch.Tensor       # (M, M)
    pivots64: torch.Tensor   # (M, dim) the raw pivots in float64
    excess: torch.Tensor     # (M,) float64 assignment excess (Cor. 1)
    knn: torch.Tensor        # (M, kk) T_S pivot-kNN distances
    sd_min: torch.Tensor     # (ns_tiles, M) Thm-2 tile stats
    sd_max: torch.Tensor
    present: torch.Tensor


@dataclasses.dataclass
class _Payload:
    """Everything the megastep reads, already on the device. Row-aligned
    tensors concatenate the segments' packed rows, each segment padded
    to whole tiles."""

    center: torch.Tensor     # (dim,) float32 shared center
    segs: tuple              # per-segment _SegGeom, in tile order
    primary: int             # the largest segment (sets the query order)
    s: Optional[torch.Tensor]    # (T·bn, dim) packed rows, zero padded,
    s_c: Optional[torch.Tensor]  # and centered (selection only); None
                                 # when the rows stay off the device
    gids: torch.Tensor       # (T·bn,) int64 global ids, -1 padding
    alive: torch.Tensor      # (T·bn,) float32, 0 on padding and tombstones
    dead_total: int          # tombstones
    n_finite_total: int      # finite T_S candidates over all segments


def segment_excess(si) -> torch.Tensor:
    """A segment's per-pivot assignment excess (float64, on its device;
    zeros for an index carried across without one)."""
    if si.s_excess is not None:
        return si.s_excess.to(torch.float64)
    return torch.zeros((si.pivots.shape[0],), dtype=torch.float64,
                       device=si.pivots.device)


def assign_theta(q: torch.Tensor, n_valid: int, pl: _Payload, *, k: int):
    """Stages 1–2 (assign → union θ) for one bucket-padded batch ``q``
    (B, dim). They read only the payload's replicated geometry (center,
    pivots, T_S lists, tombstone count), so every shard of a sharded
    payload computes the same values.

    Returns ``(qs, qcs, valid_s, inv, th_q, qps, homes)``: the queries
    sorted by their home partition in the primary segment (raw and
    centered), which of them are real, the inverse of that sort, the
    per-query θ in sorted order (−inf on padding rows), and per segment
    the sorted queries' pivot distances and home partitions.
    """
    dev = q.device
    b = q.shape[0]
    inf = float("inf")
    valid_q = torch.arange(b, device=dev) < n_valid
    qc = q - pl.center
    qc64 = q.to(torch.float64) - pl.center.to(torch.float64)

    # ---- 1. assignment against every segment's pivots (the same (B, M)
    # distance matrix feeds the bounds), in float64 on the raw rows: on
    # map coordinates a float32 |q, p_j| moves Cor. 1 by more than the
    # kNN radius (ROADMAP C15)
    qps, homes = [], []
    for g in pl.segs:
        pc = g.pivots64 - pl.center.to(torch.float64)
        d2 = torch.clamp((qc64 * qc64).sum(1)[:, None]
                         + (pc * pc).sum(1)[None, :] - 2.0 * (qc64 @ pc.T),
                         min=0.0)
        qps.append(torch.sqrt(d2))
        homes.append(torch.argmin(d2, dim=1))
    # sort queries by the primary segment's home partition so R tiles are
    # partition-coherent; padding rows sort last. Undone via ``inv``.
    m_primary = pl.segs[pl.primary].pivots_c.shape[0]
    perm = torch.argsort(torch.where(valid_q, homes[pl.primary], m_primary),
                         stable=True)
    inv = torch.argsort(perm)
    qs, qcs, valid_s = q[perm], qc[perm], valid_q[perm]
    qps = [qp[perm] for qp in qps]
    homes = [h[perm] for h in homes]

    # ---- 2. union θ: the (k + dead)-th smallest upper bound over every
    # segment's pivot-kNN candidates (Thm 3 at the query)
    ub = torch.cat([(qp[:, :, None] + g.knn[None, :, :]).reshape(b, -1)
                    for qp, g in zip(qps, pl.segs)], dim=1)
    # capped order statistic instead of a full sort: bounds for up to
    # w_cap − k tombstones stay tight, beyond that θ is +inf (visit
    # everything — still exact; compaction is overdue by then)
    w_cap = min(ub.shape[1], max(2 * k, 64))
    small = torch.topk(ub, w_cap, dim=1, largest=False, sorted=True).values
    j = k - 1 + pl.dead_total
    if (k + pl.dead_total) <= pl.n_finite_total and j < w_cap:
        th64 = small[:, j]
        th = th64.to(torch.float32)             # rounded up
        th = torch.where(th.to(torch.float64) < th64,
                         torch.nextafter(th, torch.full_like(th, inf)), th)
    else:                                       # no valid bound: visit all
        th = torch.full((b,), inf, device=dev)
    th_q = torch.where(valid_s, th, -inf)       # padding: schedule nothing
    return qs, qcs, valid_s, inv, th_q, qps, homes


def schedule_visits(qps, homes, th_q: torch.Tensor, valid_s: torch.Tensor,
                    segs, *, bm: int):
    """Stage 3: per-segment visit masks against ``segs``' tile stats,
    concatenated over the segments' tile ranges and prefix-compacted.
    Returns the compacted schedule (int32 (B // bm, T)) and its per-R-tile
    counts. A shard runs it against its own tile stats."""
    visit = torch.cat([visit_mask(qp, h, th_q, valid_s, g.pivd, g.sd_min,
                                  g.sd_max, g.present, bm=bm,
                                  excess=g.excess)
                       for qp, h, g in zip(qps, homes, segs)], dim=1)
    return compact_visits(visit)


def assign_bounds_schedule(q: torch.Tensor, n_valid: int, pl: _Payload,
                           *, k: int, bm: int):
    """Stages 1–3 (assign → union θ → compacted tile schedule) for one
    bucket-padded batch ``q`` (B, dim), over every segment of ``pl``.

    Returns ``(qs, qcs, inv, th_q, sched, cnt)``: the queries sorted by
    their home partition in the primary segment (raw and centered), the
    inverse of that sort, the per-query θ in sorted order (−inf on
    padding rows), and the compacted schedule over the concatenated
    tiles (int32 (B // bm, T)) with its per-R-tile counts (int32). The
    quantized tier's coarse pass runs on the same stages.
    """
    qs, qcs, valid_s, inv, th_q, qps, homes = assign_theta(q, n_valid, pl,
                                                           k=k)
    sched, cnt = schedule_visits(qps, homes, th_q, valid_s, pl.segs, bm=bm)
    return qs, qcs, inv, th_q, sched, cnt


def canonical_run(qs: torch.Tensor, pl: _Payload, pos: torch.Tensor):
    """Stage 5's re-rank of a run of packed-row positions (−1: empty):
    canonical distances from the raw rows, int64 global ids, one stable
    sort. Returns ``(d, ids)`` as wide as ``pos``, (+inf, −1) padded."""
    valid_sel = pos >= 0
    pos_c = torch.clamp(pos.to(torch.int64), 0, pl.s.shape[0] - 1)
    d_can = canonical_gathered(qs, pl.s[pos_c])
    d_can = torch.where(valid_sel, d_can, float("inf"))
    ids = torch.where(valid_sel, pl.gids[pos_c], -1)
    d_can, order = torch.sort(d_can, dim=1, stable=True)
    return d_can, torch.take_along_dim(ids, order, dim=1)


def merge_state(d: torch.Tensor, ids: torch.Tensor, state, k: int):
    """Dedup-merge a carried ``(dists, ids)`` run for the same query slots
    into the batch's k-run on the device."""
    sd, si = state[:2]
    pad = (0, next_pow2(k) - k)
    inf = float("inf")
    md, mi = merge_sorted_runs_unique(
        torch.nn.functional.pad(sd, pad, value=inf),
        torch.nn.functional.pad(si, pad, value=-1),
        torch.nn.functional.pad(d, pad, value=inf),
        torch.nn.functional.pad(ids, pad, value=-1))
    return md[:, :k], mi[:, :k]


def run_columns(qs: torch.Tensor, pl: _Payload, dk: torch.Tensor,
                pos: torch.Tensor):
    """Stage 5's columns of a K-G run of packed-row positions (−1:
    empty): ``(f, x, ids, d_can)`` — K-G's √d², the rows'
    ``certify.exact_d2``, int64 global ids and canonical distances from
    the raw rows, (+inf, +inf, −1, +inf) on empty slots."""
    inf = float("inf")
    valid = pos >= 0
    pos_c = torch.clamp(pos.to(torch.int64), 0, pl.s.shape[0] - 1)
    rows = pl.s[pos_c]
    return (torch.where(valid, dk, inf),
            torch.where(valid, exact_d2(qs, rows), inf),
            torch.where(valid, pl.gids[pos_c], -1),
            torch.where(valid, canonical_gathered(qs, rows), inf))


def _megastep(q: torch.Tensor, n_valid: int, pl: _Payload, *, k: int,
              bm: int, bn: int, state=None) -> StepOut:
    """assign → bounds → schedule → gather-top-k → merge for one
    bucket-padded batch ``q`` (B, dim). ``uncertified`` flags the
    queries whose run ``certify.select_run`` could not certify (their
    re-run is the engine's ``finalize``); ``lm`` is +inf."""
    qs, qcs, inv, _, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                         k=k, bm=bm)

    # ---- 4. gather top-kp over the schedule, in centered coordinates
    dk, pos = ops.distance_topk_gather(qcs, pl.s_c, run_width(k), sched,
                                       cnt, alive=pl.alive, bm=bm, bn=bn)

    # ---- 5. the k first in (exact d², id) order, their canonical
    # distances, and the run's certificate
    f, x, ids, d_can = run_columns(qs, pl, dk, pos)
    q_norm = torch.linalg.vector_norm(qcs.to(torch.float64), dim=1)
    d_can, ids, unc = select_run(f, x, ids, d_can, q_norm, k, q.shape[1])
    valid = torch.arange(q.shape[0], device=q.device) < n_valid
    d_can, ids, unc = d_can[inv], ids[inv], unc[inv] & valid
    if state is not None:
        d_can, ids = merge_state(d_can, ids, state, k)
    return StepOut(d_can, ids, torch.full((q.shape[0],), float("inf"),
                                          device=q.device), unc)


# queries an exact re-run takes together: a larger tile costs fewer
# launches but visits the union of its queries' schedules
# (``tools/bench_rerun.py`` times the choice)
RERUN_TILE = 256


def rerun_scheduled(q: torch.Tensor, shards, *, k: int, bn: int,
                    home: torch.device, bm: int = RERUN_TILE):
    """The exact k of queries ``q`` (n, dim) whose K-G run was not
    certified: ``certify.exact_topk`` over the live rows their R tile's
    schedule visits, in every payload of ``shards`` (one device's
    ``_Payload``, or each shard's). The stages 1–3 are the megastep's,
    run again on these queries alone in R tiles of ``bm``; the schedule
    holds every live row within θ of each query of the tile, ties at the
    k-th distance included, so the result is ``exact_topk``'s over all
    live rows at a fraction of the rows. Returns ``(d (n, k) float32,
    ids (n, k) int64)`` on ``home``."""
    n = q.shape[0]
    b = -(-n // bm) * bm
    order, tiles = None, []
    for sp in shards:
        dev = sp.s.device
        qj = torch.nn.functional.pad(q.to(dev), (0, 0, 0, b - n))
        qs, _, valid_s, inv, th_q, qps, homes = assign_theta(qj, n, sp, k=k)
        sched, cnt = schedule_visits(qps, homes, th_q, valid_s, sp.segs,
                                     bm=bm)
        if order is None:
            order = (qs[:n].to(home), inv[:n].to(home))
        tiles.append((sched.cpu(), cnt.cpu(), sp))
    qs, inv = order
    out_d = torch.empty((n, k), device=home)
    out_i = torch.empty((n, k), dtype=torch.int64, device=home)
    cols = torch.arange(bn)
    for t, lo in enumerate(range(0, n, bm)):
        rows, gids = [], []
        for sched, cnt, sp in tiles:
            pos = (sched[t, :int(cnt[t])].to(torch.int64)[:, None] * bn
                   + cols).reshape(-1).to(sp.s.device)
            pos = pos[sp.alive[pos] > 0]
            rows.append(sp.s[pos].to(home))
            gids.append(sp.gids[pos].to(home))
        out_d[lo:lo + bm], out_i[lo:lo + bm] = exact_topk(
            qs[lo:lo + bm], torch.cat(rows), torch.cat(gids), k)
    return out_d[inv], out_i[inv]


@dataclasses.dataclass
class JoinHandle:
    """An in-flight batch from :meth:`MegastepEngine.dispatch`: device
    tensors ``dev`` (a :class:`StepOut`; the int8 host-gather tier's
    ``(lb, pos)``; CUDA runs them asynchronously), redeemed by
    :meth:`MegastepEngine.finalize`."""

    kind: str
    n: int
    dev: tuple = ()
    q: Optional[np.ndarray] = None   # the host queries (quantized tier)
    meta: Optional[dict] = None      # what finalize counts (sharded tier)


class MegastepEngine:
    """Bucketed engine of the fused query megastep over a static
    ``SIndex`` or a ``MutableIndex``.

    Holds the index's device payload (packed rows and their centered
    copy, per-tile Thm-2 stats, pivot geometry, pivot-kNN lists,
    liveness) and rebuilds it only when the index version moves; every
    ``join_batch`` in between is one upload (the queries), one megastep
    — one K-G launch over all segments — one fetch. L2 only.
    ``step_count`` counts the megasteps this engine ran.

    Cost model: a mutation makes the next batch pay a payload rebuild
    (the concatenation of the segments' rows; per-segment pieces are
    cached, a delete redoes only the liveness mask).
    """

    can_dispatch = True

    def __init__(self, index, config: Optional[JoinConfig] = None,
                 *, bucket_min: int = 16,
                 device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        if index.device.type != dev.type:
            raise ValueError(f"the index lives on {index.device}, the "
                             f"engine was asked for {dev}")
        self.index = index
        self.device = index.device
        self.config = config or index.config
        if self.config.metric != "l2":
            raise ValueError(
                f"megastep supports metric='l2' only, got "
                f"{self.config.metric!r}")
        self.bucket_min = max(1, int(bucket_min))
        self._bn = int(self.config.tile_s)
        # largest power of two <= tile_r, so pow2 buckets always reshape
        self._bm_cap = 1 << (int(self.config.tile_r).bit_length() - 1)
        # the quantized tier keeps the fp32 rows off the device unless
        # its re-rank is resident
        self._rows_on_device = True
        self._struct = None        # (structure key, struct dict)
        self._payload = None       # (version key, _Payload)
        self._seg_cache: dict = {}
        # a payload rebuild reads several fields of the index (segments,
        # tombstones, version); a mutation racing that read could cache a
        # torn payload under a valid version key. Owners that mutate the
        # index concurrently point this at their own lock. Reentrant, so
        # an owner already holding it can query.
        self.refresh_lock: threading.RLock = threading.RLock()
        self.step_count = 0

    def bucket_for(self, n: int) -> int:
        return next_pow2(max(self.bucket_min, n))

    # ---- device payload

    def _index_parts(self):
        """``(segments, tombstones, version key)`` of the index now."""
        from .segments import MutableIndex
        if isinstance(self.index, MutableIndex):
            segs = [(si, off) for si, off in self.index.segment_snapshot()
                    if si.n_s > 0]
            return (segs, self.index.tombstones_sorted(),
                    ("mut", id(self.index), self.index.version))
        return ([(self.index, 0)], np.zeros((0,), np.int64),
                ("static", id(self.index)))

    def payload(self) -> _Payload:
        """The device payload of the index's current version, rebuilt
        (under ``refresh_lock``) when the version moved. A failure while
        building it caches nothing."""
        with self.refresh_lock:
            segs, tomb, vkey = self._index_parts()
            if self._payload is not None and self._payload[0] == vkey:
                return self._payload[1]
            if not segs:
                raise ValueError("megastep over an empty index")
            with obs.span("megastep.refresh", n_segments=len(segs),
                          n_tombstones=int(tomb.size)):
                obs.metrics.REGISTRY.counter(
                    "megastep_payload_refresh_total").inc()
                # a failure here stands in for a device OOM on the upload
                faultinject.fire("megastep.payload_upload")
                skey = (tuple(id(si) for si, _ in segs), self._bn,
                        self.config.k)
                if self._struct is None or self._struct[0] != skey:
                    self._struct = (skey, self._build_struct(segs))
                st = self._struct[1]
                # liveness and the tombstone count change per version;
                # rows, geometry and tile stats only with the structure
                alive = st["gids"] >= 0
                if tomb.size:
                    alive &= ~torch.isin(st["gids"], torch.as_tensor(
                        tomb, device=self.device))
                payload = self._make_payload(st, alive.to(torch.float32),
                                             int(tomb.size))
                self._payload = (vkey, payload)
                return payload

    def _build_struct(self, segs) -> dict:
        """The version-independent part of the payload: the segments'
        packed rows and ids concatenated tile-aligned, the shared center,
        and per-segment geometry (cached by segment identity)."""
        bn, k = self._bn, self.config.k
        live = {id(si) for si, _ in segs}
        self._seg_cache = {key: v for key, v in self._seg_cache.items()
                           if key[0] in live}
        ents = []
        for si, _ in segs:
            key = (id(si), bn)
            ent = self._seg_cache.get(key)
            if ent is None:
                pad = max(1, -(-si.n_s // bn)) * bn - si.n_s
                ent = dict(
                    si=si,
                    rows=torch.nn.functional.pad(si.s_sorted,
                                                 (0, 0, 0, pad)),
                    gids=torch.nn.functional.pad(si.s_ids_sorted, (0, pad),
                                                 value=-1),
                    stats=si.tile_stats(bn))
                self._seg_cache[key] = ent
            ents.append(ent)
        rows = torch.cat([e["rows"] for e in ents]).contiguous()
        gids = torch.cat([torch.where(e["gids"] >= 0, e["gids"] + off, -1)
                          for e, (_, off) in zip(ents, segs)])
        # one center for the selection math: distances stay comparable
        # across segments, and the ‖x‖²·eps cancellation noise shrinks to
        # O(spread²·eps) (see metrics.cmp_dist)
        center = rows[gids >= 0].to(torch.float64).mean(0).to(torch.float32)
        geoms, n_finite_total = [], 0
        for e in ents:
            si = e["si"]
            kk = min(k, si.t_s.knn_dists.shape[1])
            knn = si.t_s.knn_dists[:, :kk].contiguous()
            n_finite_total += int(torch.isfinite(knn).sum())
            sd_min, sd_max, present = e["stats"]
            geoms.append(_SegGeom(
                pivots_c=(si.pivots - center).contiguous(), pivd=si.pivd,
                pivots64=si.pivots.to(torch.float64),
                excess=segment_excess(si), knn=knn, sd_min=sd_min,
                sd_max=sd_max, present=present))
        on_dev = self._rows_on_device
        return dict(
            segs=segs, center=center, geoms=tuple(geoms),
            primary=int(np.argmax([si.n_s for si, _ in segs])),
            rows=rows, gids=gids, n_finite_total=n_finite_total,
            s=rows if on_dev else None,
            s_c=(rows - center).contiguous() if on_dev else None)

    def _make_payload(self, st: dict, alive: torch.Tensor,
                      dead_total: int) -> _Payload:
        return _Payload(
            center=st["center"], segs=st["geoms"], primary=st["primary"],
            s=st["s"], s_c=st["s_c"], gids=st["gids"], alive=alive,
            dead_total=dead_total, n_finite_total=st["n_finite_total"])

    # ---- query API

    def enqueue(self, queries: np.ndarray) -> tuple[torch.Tensor, int]:
        """Pad one micro-batch to its bucket and upload: returns the
        device queries and the host count of valid rows, ready for
        :meth:`join_batch_device`. The only host→device transfer of a
        steady-state batch; on the card it is asynchronous."""
        q = np.ascontiguousarray(queries, np.float32)
        n = q.shape[0]
        bucket = self.bucket_for(n)
        if self.device.type != "cuda":
            if bucket != n:
                q = np.pad(q, ((0, bucket - n), (0, 0)))
            return torch.from_numpy(q).to(self.device), n
        # a pinned buffer and a non-blocking copy: the host does not wait
        # for the kernels already queued (a copy from pageable memory
        # would). PyTorch's caching host allocator records the copy's
        # event and reuses the block only once the copy has completed.
        buf = torch.empty((bucket, q.shape[1]), dtype=torch.float32,
                          pin_memory=True)
        host = buf.numpy()
        host[:n] = q
        host[n:] = 0.0
        return buf.to(self.device, non_blocking=True), n

    def join_batch_device(self, q_dev: torch.Tensor, n_valid: int, *,
                          state=None) -> StepOut:
        """The steady-state call: device-padded queries in, a device
        :class:`StepOut` out — one megastep, nothing fetched, nothing
        re-uploaded, no host sync. Its ``uncertified`` queries the
        caller must re-run (``finalize`` does). ``state`` optionally
        carries a previous (dists, ids) run for the same query slots; it
        is dedup-merged on the device."""
        payload = self.payload()
        bucket = int(q_dev.shape[0])
        bm = min(bucket, self._bm_cap)
        # span timing = host launch bracket; attributes are host values
        # only — nothing here reads the device
        with obs.span("megastep.device_step", bucket=bucket, bm=bm,
                      bn=self._bn, k=self.config.k,
                      n_segments=len(payload.segs)) as sp:
            if obs.enabled():
                for stage in ("assign", "bounds", "schedule",
                              "gather_topk", "merge"):
                    obs.event(f"megastep.{stage}", fused=True)
            out = _megastep(q_dev, n_valid, payload, k=self.config.k,
                            bm=bm, bn=self._bn, state=state)
            sp.set(outcome="launched")
        self.step_count += 1
        return out

    def _validated_queries(self, queries: np.ndarray) -> np.ndarray:
        q = np.ascontiguousarray(queries, np.float32)
        if self.config.k > self.index.n_s:
            raise ValueError(f"k={self.config.k} > |S|={self.index.n_s}")
        if q.ndim != 2 or q.shape[1] != self.index.dim:
            raise ValueError(f"queries must be (n, {self.index.dim}), got "
                             f"{q.shape}")
        return q

    def dispatch(self, queries: np.ndarray, *,
                 stats: Optional[JoinStats] = None) -> JoinHandle:
        """The asynchronous half of :meth:`join_batch`: validate → build
        the payload if needed → enqueue → launch the megastep. Returns
        without waiting for the device."""
        q = self._validated_queries(queries)
        n = q.shape[0]
        if n == 0:
            return JoinHandle(kind="empty", n=0)
        payload = self.payload()
        if stats is not None:
            self._count(stats, n, payload)
        qd, nv = self.enqueue(q)
        return JoinHandle(kind="mega", n=n, dev=self.join_batch_device(qd, nv),
                          q=q)

    def _count(self, stats: JoinStats, n: int, pl: _Payload) -> None:
        stats.n_r += n
        stats.n_s = max(stats.n_s, self.index.n_s)
        stats.n_segments = len(pl.segs)
        stats.n_tombstones = pl.dead_total
        stats.pivot_pairs_computed += n * sum(
            g.pivots_c.shape[0] for g in pl.segs)

    def finalize(self, handle: JoinHandle, *,
                 stats: Optional[JoinStats] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched batch and return numpy ``(dists float32,
        ids int64)``."""
        k = self.config.k
        if handle.kind == "empty":
            return (np.zeros((0, k), np.float32),
                    np.full((0, k), -1, np.int64))
        if handle.kind != "mega":
            raise ValueError(f"cannot finalize handle kind {handle.kind!r}")
        # the fetch is the one boundary that synchronizes anyway; its wall
        # time is the device step's completion time
        t0 = time.perf_counter()
        with obs.span("megastep.fetch", rows=handle.n):
            faultinject.fire("megastep.fetch")     # a lost fetch
            out = handle.dev
            d, ids, unc = (x[:handle.n].cpu().numpy()
                           for x in (out.d, out.ids, out.uncertified))
        obs.metrics.REGISTRY.histogram("megastep_finalize_s") \
            .observe(time.perf_counter() - t0)
        self._rerun(handle, d, ids, unc, stats)
        return np.ascontiguousarray(d), np.ascontiguousarray(ids)

    def _payload_shards(self) -> tuple:
        """The payloads an exact re-run reads: this device's."""
        return (self.payload(),)

    def _rerun(self, handle: JoinHandle, d: np.ndarray, ids: np.ndarray,
               unc: np.ndarray, stats: Optional[JoinStats]) -> None:
        """Re-run the queries whose run was not certified
        (:func:`rerun_scheduled`), in place."""
        if not unc.any():
            return
        n_bad = int(unc.sum())
        with obs.span("megastep.exact_rerun", rows=n_bad):
            rd, ri = rerun_scheduled(
                torch.from_numpy(handle.q[unc]), self._payload_shards(),
                k=self.config.k, bn=self._bn, home=self.device)
            d[unc], ids[unc] = rd.cpu().numpy(), ri.cpu().numpy()
        obs.metrics.REGISTRY.counter("megastep_exact_rerun_total") \
            .inc(n_bad)
        if stats is not None:
            stats.n_exact_rerun += n_bad

    def join_batch(self, queries: np.ndarray, *,
                   stats: Optional[JoinStats] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(dists, int64 global ids) for one micro-batch — numpy in/out;
        exactly ``finalize(dispatch(q))``."""
        return self.finalize(self.dispatch(queries, stats=stats),
                             stats=stats)
