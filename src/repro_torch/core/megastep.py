"""Fused device-resident query megastep — PyTorch port of the JAX
package's ``core.megastep`` for a static ``SIndex``.

Per R micro-batch, with no host round trip between the upload of the
queries and the fetch of the result, five stages run on the device:

1. **assign** — query→pivot distances + home partitions, in coordinates
   centered on the index's mean row;
2. **bounds** — a per-query kNN radius θ: the k-th smallest of the
   Thm-3 upper bounds |q, p_j| + p_j.d_l over the T_S pivot-kNN lists;
3. **schedule** — Cor. 1 / Thm 2 per (R tile, S tile)
   (``core.schedule.visit_mask``), prefix-compacted with cumsum ranks +
   one scatter (``compact_visits``);
4. **gather top-k** — the hand-written CUDA kernel
   (``kernels.distance_topk``) on the card, its plain version on the
   CPU: each R tile walks its scheduled S tiles and keeps an ascending
   kp-run (kp = next_pow2(k) ≥ k) of d² in **centered** coordinates;
5. **merge** — canonical distances of the kp-run from the raw rows
   (``metrics.canonical_gathered``), global ids, a stable re-sort, the
   first k, and optionally an id-dedup merge with a carried state.

Both the kernel and its plain version select on centered rows (the
payload keeps a centered copy): forest-like values reach ~1000, where
the ‖x‖²·eps cancellation noise of the expanded d² would be real.

Ragged batches are padded to power-of-two buckets so the shapes repeat
(a CUDA graph per bucket is later work). The steady-state call
(:meth:`MegastepEngine.join_batch_device`) makes no host sync: every
value it branches on (θ's order-statistic index, the tombstone count,
the segment metadata) is host-side.

Exactness: the scheduled candidate set is a superset of the true top-k
(θ is a sound radius bound), the selection over it is exact, and the
reported distances are the canonical per-pair values — so a query's
result depends only on (query row, index), for any batch split.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..kernels import ops
from ..kernels.sorted_merge import merge_sorted_runs_unique, next_pow2
from .index import SIndex, not_ported
from .metrics import canonical_gathered
from .schedule import compact_visits, visit_mask
from .types import JoinConfig, JoinStats

__all__ = ["MegastepEngine", "JoinHandle", "assign_bounds_schedule"]


@dataclasses.dataclass
class _Payload:
    """Everything the megastep reads, already on the device."""

    center: torch.Tensor     # (dim,) float32 mean of the real rows
    pivots_c: torch.Tensor   # (M, dim) centered pivots
    pivd: torch.Tensor       # (M, M)
    knn: torch.Tensor        # (M, kk) T_S pivot-kNN distances
    sd_min: torch.Tensor     # (ns_tiles, M) Thm-2 tile stats
    sd_max: torch.Tensor
    present: torch.Tensor
    s: Optional[torch.Tensor]    # (ns_tiles·bn, dim) packed rows, zero
    s_c: Optional[torch.Tensor]  # padded, and centered (selection only);
                                 # None when the rows stay off the device
    gids: torch.Tensor       # (ns_tiles·bn,) int64 global ids, -1 padding
    alive: torch.Tensor      # (ns_tiles·bn,) float32, 0 on padding
    dead_total: int          # tombstones (0 for a static index)
    n_finite_total: int      # finite T_S candidates


def assign_bounds_schedule(q: torch.Tensor, n_valid: int, pl: _Payload,
                           *, k: int, bm: int):
    """Stages 1–3 (assign → θ → compacted tile schedule) for one
    bucket-padded batch ``q`` (B, dim).

    Returns ``(qs, qcs, inv, th_q, sched, cnt)``: the
    home-partition-sorted queries (raw and centered), the inverse of
    that sort, the per-query θ in sorted order (−inf on padding rows),
    and the compacted schedule (int32 (B // bm, ns_tiles)) with its
    per-R-tile counts (int32). The quantized tier's coarse pass runs on
    the same stages.
    """
    dev = q.device
    b = q.shape[0]
    m, kk = pl.knn.shape
    inf = float("inf")
    valid_q = torch.arange(b, device=dev) < n_valid
    qc = q - pl.center

    # ---- 1. assignment against the pivots (the same (B, M) distance
    # matrix feeds the bounds)
    pc = pl.pivots_c
    d2 = torch.clamp((qc * qc).sum(1)[:, None] + (pc * pc).sum(1)[None, :]
                     - 2.0 * (qc @ pc.T), min=0.0)
    qp = torch.sqrt(d2)
    home = torch.argmin(d2, dim=1)
    # sort queries by home partition so R tiles are partition-coherent;
    # padding rows sort last. Undone on the way out via ``inv``.
    perm = torch.argsort(torch.where(valid_q, home, m), stable=True)
    inv = torch.argsort(perm)
    qs, qcs, valid_s = q[perm], qc[perm], valid_q[perm]
    qp, home = qp[perm], home[perm]

    # ---- 2. θ: k-th (+ dead widening) smallest upper bound over the
    # pivot-kNN candidates (Thm 3 at the query)
    ub = (qp[:, :, None] + pl.knn[None, :, :]).reshape(b, m * kk)
    w_cap = min(m * kk, max(2 * k, 64))
    small = torch.topk(ub, w_cap, dim=1, largest=False, sorted=True).values
    j = k - 1 + pl.dead_total
    if (k + pl.dead_total) <= pl.n_finite_total and j < w_cap:
        th = small[:, j]
    else:                                       # no valid bound: visit all
        th = torch.full((b,), inf, device=dev)
    th_q = torch.where(valid_s, th, -inf)       # padding: schedule nothing

    # ---- 3. visit mask + prefix compaction
    visit = visit_mask(qp, home, th_q, valid_s, pl.pivd, pl.sd_min,
                       pl.sd_max, pl.present, bm=bm)
    sched, cnt = compact_visits(visit)
    return qs, qcs, inv, th_q, sched, cnt


def _megastep(q: torch.Tensor, n_valid: int, pl: _Payload, *, k: int,
              bm: int, bn: int, state=None):
    """assign → bounds → schedule → gather-top-k → merge for one
    bucket-padded batch ``q`` (B, dim). Returns device (dists, ids)."""
    kp = next_pow2(k)
    inf = float("inf")
    qs, qcs, inv, _, sched, cnt = assign_bounds_schedule(q, n_valid, pl,
                                                         k=k, bm=bm)

    # ---- 4. gather top-kp over the schedule, in centered coordinates
    _, pos = ops.distance_topk_gather(qcs, pl.s_c, kp, sched, cnt,
                                      alive=pl.alive, bm=bm, bn=bn)
    valid_sel = pos >= 0

    # ---- 5. canonical distances from the raw rows + global ids + the
    # stable exact re-sort of the kp-run
    pos_c = torch.clamp(pos.to(torch.int64), 0, pl.s.shape[0] - 1)
    d_can = canonical_gathered(qs, pl.s[pos_c])
    d_can = torch.where(valid_sel, d_can, inf)
    ids = torch.where(valid_sel, pl.gids[pos_c], -1)
    d_can, order = torch.sort(d_can, dim=1, stable=True)
    ids = torch.take_along_dim(ids, order, dim=1)
    d_can, ids = d_can[:, :k][inv], ids[:, :k][inv]

    if state is not None:
        sd, si = state
        pad = (0, kp - k)
        md, mi = merge_sorted_runs_unique(
            torch.nn.functional.pad(sd, pad, value=inf),
            torch.nn.functional.pad(si, pad, value=-1),
            torch.nn.functional.pad(d_can, pad, value=inf),
            torch.nn.functional.pad(ids, pad, value=-1))
        d_can, ids = md[:, :k], mi[:, :k]
    return d_can, ids


@dataclasses.dataclass
class JoinHandle:
    """An in-flight batch from :meth:`MegastepEngine.dispatch`: device
    tensors ``dev = (dists, ids)`` (CUDA runs them asynchronously),
    redeemed by :meth:`MegastepEngine.finalize`."""

    kind: str
    n: int
    dev: tuple = ()
    q: Optional[np.ndarray] = None   # the host queries (quantized tier)


class MegastepEngine:
    """Bucketed engine of the fused query megastep over a static
    ``SIndex``.

    Uploads the index's device payload (packed rows and their centered
    copy, per-tile Thm-2 stats, pivot geometry, pivot-kNN lists,
    liveness) once; every ``join_batch`` after that is one upload (the
    queries), one megastep, one fetch. L2 only. ``step_count`` counts
    the megasteps this engine ran.
    """

    can_dispatch = True

    def __init__(self, index: SIndex, config: Optional[JoinConfig] = None,
                 *, bucket_min: int = 16,
                 device: Union[str, torch.device] = "cuda"):
        if not isinstance(index, SIndex):
            raise not_ported(
                f"a megastep over {type(index).__name__} (segments / "
                f"MutableIndex)", "A2")
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
        self._payload: Optional[_Payload] = None
        self.step_count = 0

    def bucket_for(self, n: int) -> int:
        return next_pow2(max(self.bucket_min, n))

    # ---- device payload

    def payload(self) -> _Payload:
        """The device payload, built and uploaded on first use."""
        if self._payload is None:
            with obs.span("megastep.refresh", n_segments=1, n_tombstones=0):
                obs.metrics.REGISTRY.counter(
                    "megastep_payload_refresh_total").inc()
                self._payload = self._build_payload()
        return self._payload

    def _build_payload(self, *, rows_on_device: bool = True) -> _Payload:
        si, bn, k = self.index, self._bn, self.config.k
        ns_tiles = max(1, -(-si.n_s // bn))
        pad = ns_tiles * bn - si.n_s
        s = (torch.nn.functional.pad(si.s_sorted, (0, 0, 0, pad)).contiguous()
             if rows_on_device else None)
        gids = torch.nn.functional.pad(si.s_ids_sorted, (0, pad), value=-1)
        # one center for the selection math: the ‖x‖²·eps cancellation
        # noise shrinks to O(spread²·eps) (see metrics.cmp_dist)
        center = si.center()
        kk = min(k, si.t_s.knn_dists.shape[1])
        knn = si.t_s.knn_dists[:, :kk].contiguous()
        sd_min, sd_max, present = si.tile_stats(bn)
        return _Payload(
            center=center, pivots_c=(si.pivots - center).contiguous(),
            pivd=si.pivd, knn=knn, sd_min=sd_min, sd_max=sd_max,
            present=present, s=s,
            s_c=None if s is None else (s - center).contiguous(), gids=gids,
            alive=(gids >= 0).to(torch.float32), dead_total=0,
            n_finite_total=int(torch.isfinite(knn).sum()))

    # ---- query API

    def enqueue(self, queries: np.ndarray) -> tuple[torch.Tensor, int]:
        """Pad one micro-batch to its bucket and upload: returns the
        device queries and the host count of valid rows, ready for
        :meth:`join_batch_device`. The only host→device transfer of a
        steady-state batch."""
        q = np.ascontiguousarray(queries, np.float32)
        n = q.shape[0]
        bucket = self.bucket_for(n)
        if bucket != n:
            q = np.pad(q, ((0, bucket - n), (0, 0)))
        return torch.from_numpy(q).to(self.device), n

    def join_batch_device(self, q_dev: torch.Tensor, n_valid: int, *,
                          state=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The steady-state call: device-padded queries in, device
        ``(dists, int64 ids)`` out — one megastep, nothing fetched,
        nothing re-uploaded, no host sync. ``state`` optionally carries
        a previous (dists, ids) run for the same query slots; it is
        dedup-merged on the device."""
        payload = self.payload()
        bucket = int(q_dev.shape[0])
        bm = min(bucket, self._bm_cap)
        # span timing = host launch bracket; attributes are host values
        # only — nothing here reads the device
        with obs.span("megastep.device_step", bucket=bucket, bm=bm,
                      bn=self._bn, k=self.config.k, n_segments=1) as sp:
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
            stats.n_r += n
            stats.n_s = max(stats.n_s, self.index.n_s)
            stats.n_segments = 1
            stats.n_tombstones = payload.dead_total
            stats.pivot_pairs_computed += n * self.index.n_pivots
        qd, nv = self.enqueue(q)
        return JoinHandle(kind="mega", n=n, dev=self.join_batch_device(qd, nv))

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
            d, ids = handle.dev
            d = d[:handle.n].cpu().numpy()
            ids = ids[:handle.n].cpu().numpy()
        obs.metrics.REGISTRY.histogram("megastep_finalize_s") \
            .observe(time.perf_counter() - t0)
        return np.ascontiguousarray(d), np.ascontiguousarray(ids)

    def join_batch(self, queries: np.ndarray, *,
                   stats: Optional[JoinStats] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(dists, int64 global ids) for one micro-batch — numpy in/out;
        exactly ``finalize(dispatch(q))``."""
        return self.finalize(self.dispatch(queries, stats=stats),
                             stats=stats)
