"""Streaming R micro-batch engine over a resident index — PyTorch port
of the JAX package's ``core.stream``.

R arrives in micro-batches of any size; each batch is planned and
joined against a build-once ``SIndex`` or a ``MutableIndex`` by one of
three routes: the host-planned path (``plan_queries`` +
``execute_join``, or ``MutableIndex.join_batch`` over the segments; the
default), the fused megastep (``megastep=True``, ``core.megastep``) or
the int8 two-tier engine (``quantized=True``, ``quant.engine``). A
query's result depends only on (query row, live rows), so
``knn_join_batched`` over any split of R gives the same results as one
batch. ``n_shards=`` / ``mesh=`` run either megastep route over a
device mesh (``core.sharded``) — the same distances.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..kernels.sorted_merge import merge_sorted_runs_unique, next_pow2
from .api import execute_join
from .index import build_index, plan_queries
from .megastep import MegastepEngine
from .types import JoinConfig, JoinResult, JoinStats

__all__ = ["StreamJoinEngine", "StreamJoinState", "knn_join_batched"]


@dataclasses.dataclass
class StreamJoinState:
    """Running top-k per query slot, kept as ascending sorted runs.

    ``update`` merges a batch's (dists, ids) runs into the named slots
    with ``merge_sorted_runs_unique`` — a plain store for slots seen
    once, a dedup merge when a slot is revisited (the smaller distance of
    a repeated id survives, and it occupies one slot). Ids are int64.
    """

    n: int
    k: int
    distances: np.ndarray = dataclasses.field(init=False)
    indices: np.ndarray = dataclasses.field(init=False)
    _seen: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.distances = np.full((self.n, self.k), np.inf, np.float32)
        self.indices = np.full((self.n, self.k), -1, np.int64)
        self._seen = np.zeros((self.n,), bool)

    def update(self, rows: np.ndarray, d: np.ndarray, i: np.ndarray) -> None:
        """Merge ascending (|rows|, k) runs into the tracked slots."""
        rows = np.asarray(rows)
        d = np.asarray(d, np.float32)
        i = np.asarray(i, np.int64)
        # first touch of a slot is a plain store: merging an ascending
        # k-run with the all-(+inf, -1) initial run is the identity
        fresh = ~self._seen[rows]
        if fresh.any():
            fr = rows[fresh]
            self.distances[fr] = d[fresh]
            self.indices[fr] = i[fresh]
            self._seen[fr] = True
            if fresh.all():
                return
            rows, d, i = rows[~fresh], d[~fresh], i[~fresh]
        pad = ((0, 0), (0, next_pow2(self.k) - self.k))
        md, mi = merge_sorted_runs_unique(
            torch.from_numpy(np.pad(self.distances[rows], pad,
                                    constant_values=np.inf)),
            torch.from_numpy(np.pad(self.indices[rows], pad,
                                    constant_values=-1)),
            torch.from_numpy(np.pad(d, pad, constant_values=np.inf)),
            torch.from_numpy(np.pad(i, pad, constant_values=-1)))
        self.distances[rows] = md[:, :self.k].numpy()
        self.indices[rows] = mi[:, :self.k].numpy()


class StreamJoinEngine:
    """Join every incoming R micro-batch against one resident index — an
    ``SIndex`` or a ``MutableIndex``, whose batch fans over every live
    segment (base, deltas, write buffer).

    ``megastep``: ``False`` (default: the host-planned path) | ``True``
    | ``"auto"`` (the megastep when the metric is L2). ``quantized``:
    ``True`` routes every batch through the int8 two-tier engine
    (``quant.engine.QuantMegastepEngine``, L2 only) and takes
    precedence over ``megastep``; ``None`` follows ``config.quantize``.

    ``n_shards`` / ``mesh``: partition the resident payload across a mesh
    of that many devices (``distributed.make_mesh``: the present cards,
    or an explicit device list for simulated shards) and run the fused
    pass per shard (``core.sharded``) — the same distances, no
    steady-state host sync. Needs a megastep route. ``replication``
    places every pivot group on that many shards so the fp32 sharded
    engine survives shard loss with the same bits; ``attempt_timeout``
    bounds each sharded attempt so a hung collective counts as a shard
    failure. The quantized sharded engine does not replicate.
    """

    def __init__(self, index, config: Optional[JoinConfig] = None,
                 *, megastep: object = False,
                 quantized: Optional[bool] = None,
                 n_shards: Optional[int] = None, replication: int = 1,
                 attempt_timeout: Optional[float] = None, mesh=None,
                 device: Union[str, torch.device] = "cuda"):
        self.index = index
        self.config = config or index.config
        if quantized is None:
            quantized = self.config.quantize != "none"
        if megastep == "auto":
            megastep = self.config.metric == "l2"
        sharded = n_shards is not None or mesh is not None
        if (replication != 1 or attempt_timeout is not None) \
                and not sharded:
            raise ValueError(
                "replication/attempt_timeout are sharded-engine knobs — "
                "pass n_shards or mesh too")
        if index.device.type != resolve_device(device).type:
            raise ValueError(f"the index lives on {index.device}, the "
                             f"engine was asked for {device}")
        self._megastep = None
        if quantized:
            if replication != 1:
                raise ValueError(
                    "replication > 1 is the fp32 sharded engine's "
                    "fault-tolerance knob; the quantized sharded engine "
                    "does not replicate (drop quantized, or accept r=1)")
            if sharded:
                from ..quant.engine import ShardedQuantMegastepEngine
                self._megastep = ShardedQuantMegastepEngine(
                    index, self.config, n_shards=n_shards, mesh=mesh,
                    device=device)
            else:
                from ..quant.engine import QuantMegastepEngine
                self._megastep = QuantMegastepEngine(index, self.config,
                                                     device=device)
        elif megastep:
            if sharded:
                from .sharded import ShardedMegastepEngine
                self._megastep = ShardedMegastepEngine(
                    index, self.config, n_shards=n_shards, mesh=mesh,
                    replication=replication,
                    attempt_timeout=attempt_timeout, device=device)
            else:
                self._megastep = MegastepEngine(index, self.config,
                                                device=device)
        elif sharded:
            raise ValueError(
                "n_shards requires a megastep-mode engine (megastep=True/"
                "'auto' or quantized=True) — the host-planned path has no "
                "resident payload to shard")

    @property
    def megastep_engine(self):
        """The fused-path engine when enabled (None on the host path) —
        exposes the device-level ``enqueue`` / ``join_batch_device``
        API."""
        return self._megastep

    @property
    def can_dispatch(self) -> bool:
        """True when a batch can split into ``dispatch`` + ``finalize``
        (the megastep-backed routes)."""
        return self._megastep is not None

    def join_batch(self, queries: np.ndarray, *,
                   stats: Optional[JoinStats] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(dists, ids) for one micro-batch — true distances ascending,
        global S row indices."""
        queries = np.ascontiguousarray(queries, np.float32)
        if stats is not None:
            stats.n_batches += 1
        if self._megastep is not None:
            return self._megastep.join_batch(queries, stats=stats)
        return self._join_batch_host(queries, stats=stats)

    def dispatch(self, queries: np.ndarray, *,
                 stats: Optional[JoinStats] = None):
        """Asynchronous half of ``join_batch``: launch one micro-batch and
        return a ``JoinHandle`` without waiting. Pair with
        :meth:`finalize`. The host-planned route has no async half."""
        if self._megastep is None:
            raise RuntimeError(
                "dispatch() needs a megastep-backed engine; the "
                "host-planned path has no async device half (use "
                "join_batch)")
        queries = np.ascontiguousarray(queries, np.float32)
        if stats is not None:
            stats.n_batches += 1
        return self._megastep.dispatch(queries, stats=stats)

    def finalize(self, handle, *, stats: Optional[JoinStats] = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Blocking half of ``join_batch``."""
        if self._megastep is None:
            raise RuntimeError("finalize() needs a megastep-backed engine")
        return self._megastep.finalize(handle, stats=stats)

    def join_batch_host(self, queries: np.ndarray, *,
                        stats: Optional[JoinStats] = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """The host-planned path for one micro-batch, whatever route this
        engine was built with — the same results as ``join_batch``."""
        queries = np.ascontiguousarray(queries, np.float32)
        if stats is not None:
            stats.n_batches += 1
        with obs.span("stream.host_join", rows=queries.shape[0]):
            return self._join_batch_host(queries, stats=stats)

    def _join_batch_host(self, queries, *, stats=None):
        from .segments import MutableIndex

        if stats is not None:
            stats.n_r += queries.shape[0]
            stats.n_s = max(stats.n_s, self.index.n_s)
        if isinstance(self.index, MutableIndex):
            return self.index.join_batch(queries, config=self.config,
                                         stats=stats)
        qplan = plan_queries(queries, self.index, self.config)
        if stats is not None:
            stats.pivot_pairs_computed += (
                queries.shape[0] * self.index.n_pivots)
        return execute_join(queries, self.index, qplan, stats=stats)


def _iter_batches(r, batch_size: int):
    if isinstance(r, np.ndarray):
        for lo in range(0, r.shape[0], batch_size):
            yield r[lo:lo + batch_size]
    else:
        yield from r


def knn_join_batched(
    r: Union[np.ndarray, Iterable[np.ndarray]],
    s: Optional[np.ndarray] = None,
    k: int | None = None,
    config: Optional[JoinConfig] = None,
    *,
    index=None,
    batch_size: int = 0,
    megastep: object = False,
    quantized: Optional[bool] = None,
    n_shards: Optional[int] = None,
    replication: int = 1,
    mesh=None,
    device: Union[str, torch.device] = "cuda",
) -> JoinResult:
    """Streaming PGBJ join: R in micro-batches against a build-once index.

    ``r`` is one array (split into ``batch_size`` chunks; 0 =
    ``config.batch_size`` or one batch) or an iterable of micro-batch
    arrays. ``index=`` reuses a prebuilt ``SIndex`` or a
    ``MutableIndex``; otherwise the index is built here from ``s`` on
    ``device`` (pivots sampled from S).
    ``megastep=True`` runs each batch through the fused megastep,
    ``quantized=True`` through the int8 two-tier engine; the default is
    the host-planned path. ``n_shards=`` / ``mesh=`` shard either
    megastep route across a device mesh (``replication=r``: every pivot
    group on r shards, fp32 only). Every route equals one batch for any
    split.
    Row ``j`` of the output is the ``j``-th query row seen across the
    batches.
    """
    if index is not None:
        config = config or index.config
    config = config or JoinConfig(k=k or 10)
    if k is not None and k != config.k:
        config = dataclasses.replace(config, k=k)
    built_here = index is None
    n_s = None if s is None else len(s)
    if index is None:
        if s is None:
            raise ValueError("knn_join_batched needs s= or a prebuilt index")
        if config.k > n_s:
            raise ValueError(f"k={config.k} > |S|={n_s}")
        index = build_index(s, config, device=device)
    else:
        if n_s is not None and n_s != index.n_s:
            raise ValueError(
                f"s has {n_s} rows but the prebuilt index holds "
                f"{index.n_s}; results would index the wrong dataset")
        if config.k > index.n_s:
            raise ValueError(f"k={config.k} > |S|={index.n_s}")

    if batch_size <= 0:
        batch_size = config.batch_size
    if batch_size <= 0:
        batch_size = r.shape[0] if isinstance(r, np.ndarray) else 1 << 62
    batch_size = max(1, batch_size)   # |R| = 0 must not zero the stride

    engine = StreamJoinEngine(index, config, megastep=megastep,
                              quantized=quantized, n_shards=n_shards,
                              replication=replication, mesh=mesh,
                              device=device)
    stats = JoinStats(n_s=index.n_s)
    if built_here:   # a reused index's S phase 1 was paid at build time
        stats.pivot_pairs_computed += index.n_s * index.n_pivots
    chunks_d, chunks_i, seen = [], [], 0
    for batch in _iter_batches(r, batch_size):
        batch = np.ascontiguousarray(batch, np.float32)
        if batch.shape[0] == 0:
            continue
        bd, bi = engine.join_batch(batch, stats=stats)
        chunks_d.append(bd)
        chunks_i.append(bi)
        seen += batch.shape[0]
    stats.n_r = seen
    if seen == 0:
        return JoinResult(indices=np.zeros((0, config.k), np.int64),
                          distances=np.zeros((0, config.k), np.float32),
                          stats=stats)
    state = StreamJoinState(n=seen, k=config.k)
    lo = 0
    for bd, bi in zip(chunks_d, chunks_i):
        state.update(np.arange(lo, lo + bd.shape[0]), bd, bi)
        lo += bd.shape[0]
    return JoinResult(indices=state.indices, distances=state.distances,
                      stats=stats)
