"""kNN-LM retrieval — the paper's join as a serving feature. PyTorch port
of the JAX package's ``serve.retrieval``.

Datastore: (keys (N, D) hidden states, values (N,) next tokens). At each
decode step the batch of hidden states is the R side (|R| = batch) and
the datastore the S side of an R ⋉ S kNN join.

The datastore is **mutable while it serves**: it holds a segmented
``core.segments.MutableIndex``, so ``add_entries`` ingests new (key,
value) pairs mid-decode — they land in a write buffer that seals into a
small delta segment; phase 1 never re-runs on existing segments — and
``remove_entries`` tombstones stale entries without touching any
segment. ``compact()`` folds segments + tombstones back into one base
between decode steps and remaps the row-aligned ``keys``/``values``
tables to the re-based id space.

Retrieval runs one of two routes:

* the join route (default): the datastore's resident engine per k
  (``StreamJoinEngine(megastep="auto")``, the fused megastep over every
  live segment — sharded over a mesh, with replica failover, when the
  store was built with ``n_shards`` / ``mesh``) through
  :meth:`Datastore.retrieve`, whose optimistic version check returns
  the value table of exactly the index version the neighbours came
  from;
* the kernel route (``use_kernel=True``): the dense top-k kernel K-D
  (``kernels.ops.distance_topk``) over the live rows. It hands K-D the
  live rows and the queries centered by the live rows' mean (cached
  with the rows per index version) — the choice the megastep makes for
  K-G (ROADMAP Queue C3): on rows far from the origin the un-centered
  expansion's ‖x‖²·eps noise could swap near neighbours.

p(token) = (1−λ) p_LM + λ softmax(−d²/τ) aggregated over the retrieved
neighbours (Khandelwal et al. 2020). Both routes return true distances,
squared before the softmax; padding slots (id −1 / +inf) carry zero
weight, and a query with no finite neighbour gets the log-floor row.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..core import JoinConfig, MutableIndex, StreamJoinEngine
from ..core.index import as_float32_rows
from ..kernels import ops

__all__ = ["Datastore", "KnnLMConfig", "knn_logits", "interpolate"]


@dataclasses.dataclass
class Datastore:
    keys: np.ndarray       # (N_alloc, D) float32, row g = global id g
    values: np.ndarray     # (N_alloc,) int32 token ids, aligned to keys
    index: MutableIndex    # segmented mutable S side (base + deltas)
    config: JoinConfig
    # shard the resident payload across a mesh of this many devices and
    # serve through the sharded megastep (core.sharded); 0 = one device
    n_shards: int = 0
    # every pivot group on this many shards (a primary + r−1 backups), so
    # serving survives shard loss with the same bits (fp32 only)
    replication: int = 1
    # the mesh's devices (distributed.make_mesh); None: the present cards
    mesh: object = None
    # one resident engine per k: the megastep's device payload lives here
    # and survives across decode steps
    _engines: dict = dataclasses.field(default_factory=dict, repr=False)
    # guards every mutation, the engine cache and — through each
    # engine's ``refresh_lock`` — the megastep payload rebuild, so a
    # mutation racing a query can never tear the (segments, tombstones,
    # version) read a payload is built from. Queries run lock-free with
    # an optimistic version check (``retrieve``).
    _lock: object = dataclasses.field(default_factory=threading.RLock,
                                      repr=False)

    @property
    def quantized(self) -> bool:
        """Whether retrieval serves through the int8 tier: follows
        ``config.quantize``, which every segment is built with."""
        return self.config.quantize != "none"

    @classmethod
    def build(cls, keys, values, *, k: int = 8, n_pivots: int = 256,
              n_groups: int = 8, seed: int = 0, seal_threshold: int = 4096,
              quantized: bool = False, n_shards: int = 0,
              replication: int = 1, mesh=None,
              device: Union[str, torch.device] = "cuda") -> "Datastore":
        """Phase 1, once, over the initial keys on ``device``; growth
        happens in delta segments. ``keys`` may be bfloat16 / float16
        hidden states (cast to float32 once here). ``quantized=True``
        stamps ``quantize="int8"`` into the config, so every segment
        carries its int8 codes and retrieval serves through the int8
        tier. ``n_shards=N`` (or ``mesh=``, whose devices may repeat for
        simulated shards) partitions the resident payload across a mesh
        and serves through the sharded megastep — the same distances;
        ``replication=r`` keeps every pivot group on r shards (fp32)."""
        keys = as_float32_rows(keys, what="datastore keys").cpu().numpy()
        cfg = JoinConfig(k=k, n_pivots=min(n_pivots, keys.shape[0]),
                         n_groups=n_groups, grouping="geometric", seed=seed,
                         quantize="int8" if quantized else "none")
        if mesh is not None and not n_shards:
            n_shards = mesh.size
        return cls(keys=keys, values=np.asarray(values, np.int32),
                   index=MutableIndex.build(keys, cfg,
                                            seal_threshold=seal_threshold,
                                            device=device),
                   config=cfg, n_shards=int(n_shards),
                   replication=int(replication), mesh=mesh)

    @property
    def n_entries(self) -> int:
        """Live (key, value) pairs."""
        return self.index.n_s

    def add_entries(self, keys, values) -> np.ndarray:
        """Ingest new (key, value) pairs mid-decode; returns their global
        ids. Queryable from the next batch on; phase 1 runs only over the
        delta they seal into. bfloat16 / float16 keys are cast to float32
        once here; non-float dtypes raise."""
        keys = as_float32_rows(keys, what="datastore keys").cpu().numpy()
        values = np.atleast_1d(np.asarray(values, np.int32))
        if keys.shape[0] != values.shape[0]:
            raise ValueError(
                f"{keys.shape[0]} keys but {values.shape[0]} values")
        with self._lock:
            ids = self.index.insert(keys)
            self.keys = np.concatenate([self.keys, keys], axis=0)
            self.values = np.concatenate([self.values, values])
        return ids

    def remove_entries(self, ids) -> None:
        """Tombstone entries by global id (no segment touched); they stop
        being retrievable from the next batch on."""
        with self._lock:
            self.index.delete(ids)

    def compact(self) -> np.ndarray:
        """Fold segments + tombstones into one rebuilt base (between
        decode steps): re-bases ids to ``0..n_live-1`` and remaps the
        keys/values tables. Returns the old ids in new-id order."""
        with self._lock:
            old_ids = self.index.compact()
            self.keys = np.ascontiguousarray(self.keys[old_ids])
            self.values = np.ascontiguousarray(self.values[old_ids])
        return old_ids

    def engine(self, k: Optional[int] = None) -> StreamJoinEngine:
        """The resident streaming engine for ``k``, created once and
        cached; mutations reach it through the index version, and its
        payload rebuild shares this store's lock."""
        kk = self.config.k if k is None else int(k)
        with self._lock:
            eng = self._engines.get(kk)
            if eng is None:
                cfg = self.config if kk == self.config.k \
                    else dataclasses.replace(self.config, k=kk)
                sharded = bool(self.n_shards)
                rep = (self.replication if sharded and not self.quantized
                       else 1)
                eng = StreamJoinEngine(self.index, cfg, megastep="auto",
                                       quantized=self.quantized,
                                       n_shards=self.n_shards or None,
                                       mesh=self.mesh if sharded else None,
                                       replication=rep,
                                       device=self.index.device)
                me = eng.megastep_engine
                if me is not None:
                    me.refresh_lock = self._lock
                self._engines[kk] = eng
        return eng

    def recover_shards(self, *, wait: bool = False) -> list:
        """Re-admit failed shards on every cached sharded engine: rebuild
        and re-upload the shard-partitioned payloads and reset health
        (``ShardedMegastepEngine.recover``). With ``wait=False`` (the
        serving default) recovery runs in daemon threads behind each
        engine's refresh lock, serving on the degraded views meanwhile.
        Returns the recovery threads (none when nothing sharded is
        cached or failed)."""
        with self._lock:
            engines = list(self._engines.values())
        out = []
        for eng in engines:
            me = eng.megastep_engine
            if me is not None and hasattr(me, "recover"):
                t = me.recover(wait=wait)
                if t is not None:
                    out.append(t)
        return out

    def retrieve(self, queries, k: Optional[int] = None, *, stats=None,
                 max_retries: int = 8):
        """Join one batch against the live index with a consistent
        snapshot: ``(dists, ids, values)``, ``values`` being the value
        table of exactly the index version the result came from.

        Optimistic concurrency: snapshot (version, values, engine) under
        the lock, join without it, recheck the version; retry on a
        concurrent mutation, and after ``max_retries`` collisions join
        while holding the lock."""
        reg = obs.metrics.REGISTRY
        reg.counter("retrieval_joins_total").inc()
        queries = np.ascontiguousarray(queries, np.float32)
        for _ in range(max_retries):
            with self._lock:
                v0 = self.index.version
                values = self.values
                eng = self.engine(k)
            try:
                d, idx = eng.join_batch(queries, stats=stats)
            except Exception:
                with self._lock:
                    if self.index.version != v0:
                        reg.counter(
                            "retrieval_version_retries_total").inc()
                        continue     # mutated mid-join: retry, not a fault
                raise
            with self._lock:
                if self.index.version == v0:
                    return d, idx, values
            reg.counter("retrieval_version_retries_total").inc()
        with self._lock:             # write-heavy: serialize this one
            d, idx = self.engine(k).join_batch(queries, stats=stats)
            return d, idx, self.values

    def lookup_tokens(self, ids: np.ndarray,
                      values: Optional[np.ndarray] = None) -> np.ndarray:
        """Global ids → tokens against ``values`` (a snapshot from
        :meth:`retrieve`) or the current table; padding ids (−1) map to
        token 0 — their weight is masked anyway."""
        if values is None:
            with self._lock:
                values = self.values
        toks = values[np.clip(ids, 0, values.shape[0] - 1)]
        return np.where(ids >= 0, toks, 0)


@dataclasses.dataclass(frozen=True)
class KnnLMConfig:
    lam: float = 0.25
    tau: float = 10.0
    k: int = 8


_LOG_FLOOR = np.float32(np.log(1e-9))


def knn_logits(queries, store: Datastore, kcfg: KnnLMConfig, vocab: int, *,
               use_kernel: bool = False, scheduler=None,
               deadline_s: Optional[float] = None,
               return_neighbors: bool = False):
    """Retrieval distribution per query, (B, vocab) log-space numpy.

    ``use_kernel=False`` (default) runs the batch through the
    datastore's resident engine (:meth:`Datastore.retrieve`);
    ``use_kernel=True`` runs the dense top-k kernel over the store's
    live rows, centered. Distances are squared before
    ``softmax(−d²/τ)``; padded slots are excluded, and a query with no
    finite neighbour gets the flat log-floor row.

    ``scheduler`` (a ``serve.scheduler.ServeScheduler``) routes the
    batch through admission control instead of calling the engine
    directly: under overload the result may be certified-approximate,
    and a shed or rejected batch degrades to the log-floor rows — the
    interpolation then falls back to the LM distribution alone.
    ``deadline_s`` bounds the retrieval's staleness on that route.
    ``return_neighbors=True`` also returns the neighbours the
    distribution came from: ``(logits, (dists, global ids))``.
    """
    queries = as_float32_rows(queries, what="queries").cpu().numpy()
    nq = queries.shape[0]
    k_eff = min(kcfg.k, store.index.n_s)
    if k_eff == 0:
        floor = np.full((nq, vocab), _LOG_FLOOR, np.float32)
        if return_neighbors:
            return floor, (np.zeros((nq, 0), np.float32),
                           np.zeros((nq, 0), np.int64))
        return floor
    values = None
    if scheduler is not None:
        t = scheduler.join_now(queries, deadline_s=deadline_s)
        if not t.done:               # shed / rejected: LM-only this step
            floor = np.full((nq, vocab), _LOG_FLOOR, np.float32)
            if return_neighbors:
                return floor, (np.full((nq, k_eff), np.inf, np.float32),
                               np.full((nq, k_eff), -1, np.int64))
            return floor
        d, idx = t.distances, t.indices
    elif use_kernel:
        with store._lock:
            rows_c, center, gids = store.index.live_device_centered()
            values = store.values
        q = torch.as_tensor(queries, device=rows_c.device) - center
        d, local = ops.distance_topk(q, rows_c, k_eff)
        d = d.cpu().numpy()
        local = local.cpu().numpy()
        idx = np.where(local >= 0,
                       gids[np.clip(local, 0, gids.shape[0] - 1)], -1)
    else:
        d, idx, values = store.retrieve(queries, k_eff)
    valid = (idx >= 0) & np.isfinite(d)
    d_cmp = np.square(d) if store.config.metric == "l2" else d
    x = np.where(valid, -d_cmp / kcfg.tau, -np.inf).astype(np.float32)
    # masked softmax: padded slots carry zero weight; an all-masked row
    # yields all-zero weights, not 0/0
    m = np.max(x, axis=1, keepdims=True)
    m = np.where(np.isfinite(m), m, np.float32(0.0))
    e = np.where(valid, np.exp(x - m), np.float32(0.0)).astype(np.float32)
    z = e.sum(axis=1, keepdims=True)
    w = e / np.maximum(z, np.float32(1e-30))
    toks = store.lookup_tokens(idx, values)     # (B, k); masked: w is 0
    probs = np.zeros((nq, vocab), np.float32)
    np.add.at(probs, (np.arange(nq)[:, None], toks), w)
    out = np.log(np.maximum(probs, 1e-9))
    return (out, (d, idx)) if return_neighbors else out


def interpolate(lm_logits: torch.Tensor, knn_log, lam: float
                ) -> torch.Tensor:
    """(1−λ)·p_LM + λ·p_kNN, mixed in probability space, returned as
    logits (a tensor on ``lm_logits``' device)."""
    p_lm = torch.softmax(lm_logits, dim=-1)
    p_knn = torch.exp(torch.as_tensor(knn_log, dtype=p_lm.dtype,
                                      device=p_lm.device))
    p_knn = p_knn / torch.clamp(p_knn.sum(-1, keepdim=True), min=1e-9)
    return torch.log(torch.clamp((1 - lam) * p_lm + lam * p_knn, min=1e-9))
