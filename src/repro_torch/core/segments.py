"""Mutable segmented index — online inserts and deletes over the serving
datastore, exact. PyTorch port of the JAX package's ``core.segments``.

* ``MutableIndex`` holds an ordered list of sealed segments (each a full
  ``SIndex`` over its own rows, on the index's device) plus a small write
  buffer of host rows. ``insert`` appends to the buffer; once the buffer
  reaches ``seal_threshold`` rows it is *sealed* into a new delta
  ``SIndex`` (phase 1 over the delta rows only). ``delete`` records
  global ids in a tombstone set — no segment is touched. ``compact``
  folds segments + buffer − tombstones into one rebuilt base (the only
  operation that re-runs phase 1 over old rows).

* Ids are **global and int64**: each segment owns the contiguous range
  ``id_offset .. id_offset + n_rows``. Ids are stable across inserts and
  deletes and change only at ``compact``, which re-bases the survivors
  to ``0..n_live-1`` (ascending old-id order) and returns the old ids so
  callers can remap row-aligned payloads.

* Queries stay **exact**. The host route (:meth:`MutableIndex.join_batch`)
  fans a batch over every live segment — per-segment ``plan_queries`` +
  ``execute_join``, any reducer — over-fetching adaptively (``k +
  min(dead, k)`` first, the certain ``k + dead`` for the queries whose
  masked run proves incomplete), masks dead rows, and folds the runs
  through ``StreamJoinState``'s dedup merge. The megastep routes cover
  every segment, the write buffer included (``segment_snapshot``), in
  one launch (``core.megastep``). Every route reports the canonical
  per-pair distances, so results equal a fresh ``build_index`` over the
  survivors bit for bit (ids up to the remap, and up to which of
  several rows at exactly the same distance is reported).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from .api import execute_join
from .index import SIndex, as_float32_rows, build_index, plan_queries
from .metrics import canonical_topk, cmp_dist
from .partition import build_summary
from .stream import StreamJoinState
from .types import JoinConfig, JoinStats

__all__ = ["Segment", "MutableIndex"]


@dataclasses.dataclass
class Segment:
    """One sealed immutable segment: a full ``SIndex`` over its rows plus
    the global id range it owns (``id_offset .. id_offset + n_rows``)."""

    index: SIndex
    id_offset: int
    _t_s_wide: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_rows(self) -> int:
        return self.index.n_s

    def index_for_k(self, k: int) -> SIndex:
        """The segment's index with a T_S wide enough for a k-row fetch.

        Tombstone masking over-fetches (k + dead rows), which can exceed
        the pivot-kNN width T_S was built with. The lists are a pure
        function of the stored (s_part, s_dist), so widening is a
        re-summarize — no assignment, no distance. Widths round up to a
        power of two and are cached, so the cache stays O(log k).
        """
        width = self.index.t_s.knn_dists.shape[1]
        if k <= width:
            return self.index
        cap = 1 << max(0, (min(k, self.n_rows) - 1).bit_length())
        cap = min(max(cap, k), self.n_rows)
        if cap not in self._t_s_wide:
            t_s = build_summary(self.index.s_part, self.index.s_dist,
                                self.index.n_pivots, k=cap)
            self._t_s_wide[cap] = dataclasses.replace(self.index, t_s=t_s)
        return self._t_s_wide[cap]


class MutableIndex:
    """A mutable, segmented, exact kNN index over a changing dataset S.

    Goes wherever an ``SIndex`` goes on the query side:
    ``knn_join(r, index=mi)``, ``knn_join_batched(r, index=mi)``,
    ``StreamJoinEngine(mi)`` and ``serve.Datastore``. Every sealed or
    compacted ``SIndex`` is built on ``device`` (default ``"cuda"``; the
    base's device when a base is given).
    """

    def __init__(self, base: Optional[SIndex] = None,
                 config: Optional[JoinConfig] = None, *,
                 seal_threshold: int = 4096,
                 device: Union[str, torch.device, None] = None):
        if base is None and config is None:
            raise ValueError("MutableIndex needs a base SIndex or a config")
        if seal_threshold < 1:
            raise ValueError("seal_threshold must be >= 1")
        if base is not None:
            if device is not None and resolve_device(device).type \
                    != base.device.type:
                raise ValueError(f"the base index lives on {base.device}, "
                                 f"the index was asked for {device}")
            self.device = base.device
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.config = config or base.config
        self.seal_threshold = int(seal_threshold)
        self.segments: list[Segment] = []
        self._next_id = 0
        if base is not None:
            self.segments.append(Segment(base, 0))
            self._next_id = base.n_s
        self._tombstones: set[int] = set()
        self._tomb_sorted: Optional[np.ndarray] = None
        self._buffer: list[np.ndarray] = []
        self._buffer_ids: list[np.ndarray] = []
        self._n_buffer = 0
        self._version = 0
        self._live_cache = None
        self._buffer_seg = None
        self.last_compact_s = 0.0

    @classmethod
    def build(cls, s, config: Optional[JoinConfig] = None, *,
              seal_threshold: int = 4096,
              device: Union[str, torch.device] = "cuda") -> "MutableIndex":
        """Phase 1 over the initial S on ``device``, wrapped mutable."""
        config = config or JoinConfig()
        return cls(build_index(s, config, device=device), config,
                   seal_threshold=seal_threshold)

    # ---- sizes / introspection

    @property
    def n_s(self) -> int:
        """Live row count (the ``SIndex`` property callers validate k
        against)."""
        return self._next_id - len(self._tombstones)

    @property
    def n_live(self) -> int:
        return self.n_s

    @property
    def n_segments(self) -> int:
        """Sealed segments plus the write buffer if it holds rows."""
        return len(self.segments) + (1 if self._n_buffer else 0)

    @property
    def n_tombstones(self) -> int:
        return len(self._tombstones)

    @property
    def n_buffered(self) -> int:
        return self._n_buffer

    @property
    def dim(self) -> int:
        if self.segments:
            return self.segments[0].index.dim
        if self._buffer:
            return self._buffer[0].shape[1]
        raise ValueError("empty MutableIndex has no dimensionality yet")

    # ---- mutation

    def insert(self, rows) -> np.ndarray:
        """Append rows; returns their new global int64 ids. Rows land in
        the write buffer (queryable at once) and seal into a delta
        ``SIndex`` once the buffer reaches ``seal_threshold``. bfloat16 /
        float16 rows are cast to float32 once here; non-float dtypes are
        rejected."""
        rows = as_float32_rows(rows, what="inserted rows").cpu().numpy()
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ValueError(f"insert needs (n, dim) rows, got {rows.shape}")
        if self.segments or self._buffer:
            if rows.shape[1] != self.dim:
                raise ValueError(
                    f"insert dim {rows.shape[1]} != index dim {self.dim}")
        ids = np.arange(self._next_id, self._next_id + rows.shape[0],
                        dtype=np.int64)
        self._next_id += rows.shape[0]
        self._buffer.append(rows)
        self._buffer_ids.append(ids)
        self._n_buffer += rows.shape[0]
        self._version += 1
        reg = obs.metrics.REGISTRY
        reg.counter("index_insert_rows_total").inc(rows.shape[0])
        reg.gauge("index_segments").set(self.n_segments)
        if self._n_buffer >= self.seal_threshold:
            self.seal()
        return ids

    def seal(self) -> Optional[Segment]:
        """Flush the write buffer into a sealed delta segment (no-op when
        empty); phase 1 runs over the buffered rows only."""
        if self._n_buffer == 0:
            return None
        rows = np.concatenate(self._buffer, axis=0)
        offset = int(self._buffer_ids[0][0])
        self._buffer, self._buffer_ids, self._n_buffer = [], [], 0
        self._buffer_seg = None
        with obs.span("index.seal", rows=rows.shape[0]):
            seg = Segment(build_index(rows, self.config, device=self.device),
                          offset)
        self.segments.append(seg)
        self._version += 1
        reg = obs.metrics.REGISTRY
        reg.counter("index_seal_total").inc()
        reg.gauge("index_segments").set(self.n_segments)
        return seg

    def delete(self, ids) -> None:
        """Tombstone rows by global id; no segment is touched. Raises on
        ids never allocated, already dead, or repeated in the call."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        bad = ids[(ids < 0) | (ids >= self._next_id)]
        if bad.size:
            raise ValueError(f"unknown row ids {bad[:5].tolist()} "
                             f"(allocated id space is [0, {self._next_id}))")
        new = set(ids.tolist())
        if len(new) != ids.size:
            raise ValueError("duplicate ids in one delete call")
        dead = new & self._tombstones
        if dead:
            raise ValueError(f"ids already deleted: {sorted(dead)[:5]}")
        self._tombstones |= new
        self._tomb_sorted = None
        self._version += 1
        reg = obs.metrics.REGISTRY
        reg.counter("index_delete_rows_total").inc(ids.size)
        reg.gauge("index_tombstones").set(len(self._tombstones))

    def compact(self, *, stats: Optional[JoinStats] = None) -> np.ndarray:
        """Fold segments + buffer − tombstones into one rebuilt base.
        Survivors are re-based to ids ``0..n_live-1`` in ascending old-id
        order; returns the old ids in new-id order (``payload_new =
        payload_old[ret]``)."""
        t0 = time.perf_counter()
        with obs.span("index.compact", n_segments=self.n_segments,
                      n_tombstones=self.n_tombstones):
            rows, old_ids = self.live_rows()
            self.segments = []
            self._buffer, self._buffer_ids, self._n_buffer = [], [], 0
            # compact re-bases _next_id downward, so a later buffer could
            # reproduce the cached view's key (_next_id, n_buffer) while
            # holding different rows: drop the view
            self._buffer_seg = None
            self._tombstones.clear()
            self._tomb_sorted = None
            self._next_id = rows.shape[0]
            if rows.shape[0]:
                self.segments.append(Segment(
                    build_index(rows, self.config, device=self.device), 0))
            self._version += 1
        self.last_compact_s = time.perf_counter() - t0
        reg = obs.metrics.REGISTRY
        reg.counter("index_compact_total").inc()
        reg.histogram("index_compact_s").observe(self.last_compact_s)
        reg.gauge("index_segments").set(self.n_segments)
        reg.gauge("index_tombstones").set(0)
        if stats is not None:
            stats.compact_time_s += self.last_compact_s
        return old_ids

    # ---- views

    @property
    def version(self) -> int:
        """Monotonic mutation counter (every insert / seal / delete /
        compact bumps it). Device-resident consumers key their payload on
        it and rebuild only when it moves."""
        return self._version

    def tombstones_sorted(self) -> np.ndarray:
        """The tombstoned global ids, ascending int64."""
        return self._tomb_array()

    def segment_snapshot(self) -> list[tuple[SIndex, int]]:
        """``(index, id_offset)`` of every live segment, *including* the
        unsealed write buffer presented through an ephemeral delta
        ``SIndex`` (phase 1 over the buffered rows only, cached until the
        buffer changes, never mutating this index) — the fan-out set one
        megastep call covers."""
        out = [(seg.index, seg.id_offset) for seg in self.segments]
        if self._n_buffer:
            key = (self._next_id, self._n_buffer)
            if self._buffer_seg is None or self._buffer_seg[0] != key:
                rows = np.concatenate(self._buffer, axis=0)
                offset = int(self._buffer_ids[0][0])
                self._buffer_seg = (key, build_index(rows, self.config,
                                                     device=self.device),
                                    offset)
            out.append((self._buffer_seg[1], self._buffer_seg[2]))
        return out

    def nbytes_resident(self, *, quantized: Optional[bool] = None) -> int:
        """Device-resident row-payload bytes over all live segments (the
        write buffer's view included)."""
        return sum(si.nbytes_resident(quantized=quantized)
                   for si, _ in self.segment_snapshot())

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Numpy ``(rows, global ids)`` of every surviving row, ascending
        by id — the order ``compact`` re-bases to and a fresh
        ``build_index`` oracle sees."""
        rows, _, _, gids = self._live_view()
        return rows.to("cpu", copy=True).numpy(), gids.copy()

    def live_device_rows(self) -> tuple[torch.Tensor, np.ndarray]:
        """Live rows as a tensor on the index's device + their global
        ids, cached until the next mutation (the brute-force retrieval
        route's view of the datastore)."""
        rows, _, _, gids = self._live_view()
        return rows, gids

    def live_device_centered(self) -> tuple[torch.Tensor, torch.Tensor,
                                            np.ndarray]:
        """``(rows − center, center, global ids)`` of the live rows, with
        ``center`` their mean (float64 mean rounded to float32), cached
        with them per version: selection in expanded d² on centered rows
        keeps the ‖x‖²·eps cancellation noise at O(spread²·eps)."""
        _, rows_c, center, gids = self._live_view()
        return rows_c, center, gids

    def _live_view(self):
        """The live rows, ascending by global id, assembled on the
        index's device (the segments' rows never leave it), with their
        center and centered copy; cached per version."""
        if self._live_cache is None or self._live_cache[0] != self._version:
            dev = self.device
            tomb = torch.as_tensor(self._tomb_array(), device=dev)
            parts, id_parts = [], []
            for seg in self.segments:
                local = torch.arange(seg.n_rows, device=dev)
                parts.append(seg.index.rows_for_ids(local))
                id_parts.append(local + seg.id_offset)
            for rows, gids in zip(self._buffer, self._buffer_ids):
                parts.append(torch.as_tensor(rows, device=dev))
                id_parts.append(torch.as_tensor(gids, device=dev))
            if parts:
                ids = torch.cat(id_parts)
                keep = ~torch.isin(ids, tomb)
                dev_rows = torch.cat(parts)[keep].contiguous()
                gids = ids[keep].cpu().numpy()
            else:
                d = self.dim if self._buffer else 0
                dev_rows = torch.zeros((0, d), device=dev)
                gids = np.zeros((0,), np.int64)
            center = (dev_rows.to(torch.float64).mean(0).to(torch.float32)
                      if dev_rows.shape[0] else
                      torch.zeros(dev_rows.shape[1], device=dev))
            self._live_cache = (self._version, dev_rows,
                                (dev_rows - center).contiguous(), center,
                                gids)
        return self._live_cache[1:]

    def _tomb_array(self) -> np.ndarray:
        if self._tomb_sorted is None:
            self._tomb_sorted = np.fromiter(
                sorted(self._tombstones), np.int64, len(self._tombstones))
        return self._tomb_sorted

    # ---- query (the host route)

    def join_batch(self, queries, *, config: Optional[JoinConfig] = None,
                   stats: Optional[JoinStats] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Exact numpy ``(dists, global ids)`` of the batch's k nearest
        live rows: per-segment planning + join through the configured
        reducer with tombstone over-fetch, dead rows masked, the runs
        folded through the ``StreamJoinState`` dedup merge."""
        cfg = config or self.config
        k = cfg.k
        queries = as_float32_rows(queries, what="R rows").cpu().numpy()
        nq = queries.shape[0]
        if k > self.n_s:
            raise ValueError(f"k={k} > live rows |S|={self.n_s}")
        if stats is not None:
            stats.n_segments = self.n_segments
            stats.n_tombstones = self.n_tombstones
        if nq == 0:
            return (np.zeros((0, k), np.float32),
                    np.full((0, k), -1, np.int64))
        tomb = self._tomb_array()
        state = StreamJoinState(n=nq, k=k)
        all_rows = np.arange(nq)
        for seg in self.segments:
            # the segment owns a contiguous id range, so its tombstone
            # count is one sorted-range probe
            n_dead = int(np.searchsorted(tomb, seg.id_offset + seg.n_rows)
                         - np.searchsorted(tomb, seg.id_offset))
            if seg.n_rows == n_dead:
                continue   # fully tombstoned segment
            d, gids = self._join_segment(queries, seg, n_dead, tomb, cfg,
                                         stats)
            state.update(all_rows, d, gids)
        if self._n_buffer:
            d, gids = self._join_buffer(queries, k, tomb, cfg, stats)
            if d is not None:
                state.update(all_rows, d, gids)
        return state.distances, state.indices

    def _join_segment(self, queries, seg: Segment, n_dead: int,
                      tomb: np.ndarray, cfg: JoinConfig, stats):
        """One segment's masked top-k runs, with adaptive over-fetch: a
        fetch of the top-m holds the top-j live rows for the j of them
        that survive, so a query still showing min(k, live) live entries
        is complete; the rest re-run at the certain ``k + n_dead``."""
        k = cfg.k
        need = min(k, seg.n_rows - n_dead)
        m_full = min(seg.n_rows, k + n_dead)
        m1 = min(m_full, k + min(n_dead, k))
        d, gids = self._fetch_segment_topm(queries, seg, m1, cfg, stats)
        d, gids = _mask_dead(d, gids, tomb)
        if m1 < m_full:
            lack = (gids >= 0).sum(axis=1) < need
            if lack.any():
                d2, g2 = self._fetch_segment_topm(
                    queries[lack], seg, m_full, cfg, stats)
                d2, g2 = _mask_dead(d2, g2, tomb)
                d, gids = _trim(d, gids, k)
                d2, g2 = _trim(d2, g2, k)
                d[lack], gids[lack] = d2, g2
                return d, gids
        return _trim(d, gids, k)

    def _fetch_segment_topm(self, queries, seg: Segment, m: int,
                            cfg: JoinConfig, stats):
        """Exact top-m of one segment (global ids, canonical distances)
        through the configured reducer."""
        seg_cfg = cfg if m == cfg.k else dataclasses.replace(cfg, k=m)
        index = seg.index_for_k(m)
        qplan = plan_queries(queries, index, seg_cfg)
        if stats is not None:
            stats.pivot_pairs_computed += queries.shape[0] * index.n_pivots
        d, local = execute_join(queries, index, qplan, stats=stats)
        return d, np.where(local >= 0, local + seg.id_offset, -1)

    def _join_buffer(self, queries, k, tomb, cfg, stats):
        """Brute-force the unsealed write buffer (fewer than
        ``seal_threshold`` rows), reported through the canonical chain;
        ties in the selection go to the lower id."""
        rows = np.concatenate(self._buffer, axis=0)
        gids = np.concatenate(self._buffer_ids)
        dead = _in_sorted(gids, tomb)
        n_dead = int(dead.sum())
        if n_dead == rows.shape[0]:
            return None, None
        k_fetch = min(rows.shape[0], k + n_dead)
        q_t = torch.as_tensor(queries, device=self.device)
        rows_t = torch.as_tensor(rows, device=self.device)
        dc = cmp_dist(q_t, rows_t, cfg.metric)
        if stats is not None:
            stats.pairs_computed += int(dc.numel())
        sel = torch.sort(dc, dim=1, stable=True).indices[:, :k_fetch]
        gids_t = torch.as_tensor(gids, device=self.device)
        d, ids = canonical_topk(q_t, gids_t[sel], rows_t[sel], cfg.metric)
        return _trim(*_mask_dead(d.cpu().numpy(), ids.cpu().numpy(), tomb),
                     k)

    def __repr__(self) -> str:
        return (f"MutableIndex(n_live={self.n_s}, "
                f"segments={len(self.segments)}, "
                f"buffered={self._n_buffer}, "
                f"tombstones={self.n_tombstones}, device={self.device})")


def _in_sorted(ids: np.ndarray, sorted_ids: np.ndarray) -> np.ndarray:
    """Membership of ``ids`` in an ascending id array (−1 padding is
    never a member)."""
    if sorted_ids.size == 0:
        return np.zeros(ids.shape, bool)
    pos = np.searchsorted(sorted_ids, ids)
    pos = np.clip(pos, 0, sorted_ids.size - 1)
    return sorted_ids[pos] == ids


def _mask_dead(d: np.ndarray, ids: np.ndarray, tomb: np.ndarray,
               ) -> tuple[np.ndarray, np.ndarray]:
    """Demote tombstoned ids to (+inf, -1) and restore ascending order
    (stable, so the surviving run order is untouched)."""
    if tomb.size:
        dead = _in_sorted(ids, tomb) & (ids >= 0)
        if dead.any():
            d = np.where(dead, np.float32(np.inf), d)
            ids = np.where(dead, np.int64(-1), ids)
            order = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
    return d, ids


def _trim(d: np.ndarray, ids: np.ndarray, k: int,
          ) -> tuple[np.ndarray, np.ndarray]:
    """Normalize a masked run to exactly k columns (truncate an
    over-fetch, pad an under-full segment with (+inf, -1))."""
    if d.shape[1] > k:
        d, ids = d[:, :k], ids[:, :k]
    elif d.shape[1] < k:
        pad = ((0, 0), (0, k - d.shape[1]))
        d = np.pad(d, pad, constant_values=np.inf)
        ids = np.pad(ids, pad, constant_values=-1)
    return np.ascontiguousarray(d), np.ascontiguousarray(ids)
