"""Build-once S-index + per-batch query planner — PyTorch port of the JAX
package's ``core.index``.

* ``SIndex`` — built once per dataset S by :func:`build_index`: pivots,
  the pivot-distance matrix, S's partition assignment and summary table
  T_S, and the S rows packed in pivot-sorted (partition, pivot
  distance) order, so every tile cut from the packed rows is
  partition-coherent; optionally the packed rows' int8 twin
  (:meth:`SIndex.ensure_quant`). Tensors on one device.
* ``QueryPlan`` — built per R batch by :func:`plan_queries`: the batch's
  assignment, T_R, θ (Alg. 1 / Thm 3), the replication lower-bound
  matrix (Cor. 2) and the §5 grouping. Assignment and bounds are
  device ops; grouping is a host numpy loop.
* ``ShardPacking`` — one segment's packed rows laid out over the shards
  of a mesh (:meth:`SIndex.shard_packing`): the §5 geometric grouping
  places pivot groups on shards, ``r`` replicas of each, host numpy
  arrays the sharded engines upload (``core.sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..quant.quantize import QuantizedRows, quantize_rows
from . import bounds as B
from . import grouping as G
from .partition import (assign_and_summarize, assign_to_pivots,
                        assignment_excess, build_summary)
from .pivots import select_pivots
from .schedule import segment_tile_stats
from .types import JoinConfig, SummaryTable

__all__ = ["SIndex", "QueryPlan", "ShardPacking", "build_index",
           "plan_queries", "sindex_from_arrays", "as_float32_rows"]

_FLOAT_DTYPES = {"float32", "float64", "float16", "bfloat16"}


def as_float32_rows(x, *, what: str = "rows") -> torch.Tensor:
    """Boundary cast for incoming rows: float32/float64/float16/bfloat16
    (numpy arrays or tensors) become one contiguous float32 tensor on the
    input's device — one cast, never a float64 round trip — and
    non-float dtypes are rejected instead of being coerced."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if str(t.dtype).removeprefix("torch.") not in _FLOAT_DTYPES:
        raise TypeError(
            f"{what} must be floating point (float32/float16/bfloat16), "
            f"got dtype {t.dtype}")
    return t.to(torch.float32).contiguous()


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error for a route of the JAX package the port does not have
    yet, naming the ROADMAP Queue A item that brings it."""
    return NotImplementedError(
        f"{feature} is not ported yet (ROADMAP Queue {item})")


@dataclasses.dataclass
class ShardPacking:
    """One segment's packed payload laid out per shard of a device mesh
    (host numpy arrays, as in the JAX package's ``ShardPacking``).

    Pivot groups are assigned to shards by the paper's §5 geometric
    grouping balanced by partition population — the heuristic that
    balances reducers balances shards. Each shard's rows are a subset of
    the pivot-sorted packed layout, so its block stays in (partition,
    pivot distance) order and its tiles partition-coherent; every shard
    is padded to the same ``tiles_per_shard`` (rows 0, gids/part −1).
    Per-shard Thm-2 tile stats cover the shard's own rows: partitions it
    does not hold are never ``present``, so a shard's visit schedule
    covers only its own tiles.

    With replication ``r > 1`` every pivot group also lands on ``r − 1``
    backup shards, each replica the same pivot-sorted slice, so any
    *serving view* (one live owner per partition, :meth:`owner_view`)
    presents exactly the single-device row set.
    """

    n_shards: int
    bn: int
    shard_of_part: np.ndarray   # (M,) int32 — primary shard per partition
    tiles_per_shard: int        # uniform (max-padded) S-tile count
    rows: np.ndarray            # (n_shards, tiles*bn, dim) float32
    gids_local: np.ndarray      # (n_shards, tiles*bn) int64, -1 padding
    part: np.ndarray            # (n_shards, tiles*bn) int32, -1 padding
    dist: np.ndarray            # (n_shards, tiles*bn) float32
    rows_per_shard: np.ndarray  # (n_shards,) int64 — real rows per shard
    sd_min: np.ndarray          # (n_shards, tiles, M) per-shard Thm-2 stats
    sd_max: np.ndarray          # (n_shards, tiles, M)
    present: np.ndarray         # (n_shards, tiles, M) bool
    # replication factor and the (r, M) replica table: row 0 is the
    # primary (== shard_of_part), rows 1..r−1 the backups, all distinct
    r: int = 1
    replicas_of_part: Optional[np.ndarray] = None
    _quant: object = dataclasses.field(
        default=None, repr=False, compare=False)

    def owner_view(self, failed=()) -> np.ndarray:
        """(M,) int32 — the shard that serves each partition under a set
        of failed shards: the primary while it lives, else the first live
        backup, else −1 (an **uncovered** pivot group).
        ``owner_view(())`` is ``shard_of_part`` itself."""
        failed = frozenset(int(f) for f in failed)
        if not failed:
            return self.shard_of_part
        reps = (self.replicas_of_part if self.replicas_of_part is not None
                else self.shard_of_part[None, :])
        bad = np.asarray(sorted(failed), np.int32)
        owner = np.full((reps.shape[1],), -1, np.int32)
        for c in range(reps.shape[0]):
            cand = reps[c]
            take = (owner < 0) & ~np.isin(cand, bad)
            owner[take] = cand[take]
        return owner

    def serve_mask(self, owner: np.ndarray) -> np.ndarray:
        """(n_shards, tiles*bn) bool — which held rows each shard serves
        under ``owner``: exactly one shard serves each row of a covered
        partition, so the served rows are the single-device row set
        minus the uncovered partitions."""
        safe = np.clip(self.part, 0, owner.shape[0] - 1)
        return ((self.part >= 0)
                & (owner[safe] == np.arange(self.n_shards,
                                            dtype=np.int32)[:, None]))

    def present_view(self, owner: np.ndarray) -> np.ndarray:
        """(n_shards, tiles, M) bool — Thm-2 ``present`` gated to the
        partitions each shard serves, so schedules skip standby
        replicas."""
        gate = (owner[None, :] == np.arange(self.n_shards,
                                            dtype=np.int32)[:, None])
        return self.present & gate[:, None, :]

    def partition_counts(self) -> np.ndarray:
        """(M,) int64 — real rows per partition, each counted once."""
        m = self.shard_of_part.shape[0]
        cnt = np.bincount(self.part[self.part >= 0].ravel(), minlength=m)
        return (cnt // max(1, self.r)).astype(np.int64)

    def uncovered_parts(self, owner: np.ndarray) -> np.ndarray:
        """(M,) bool — populated partitions no live shard serves."""
        return (owner < 0) & (self.partition_counts() > 0)

    def coverage_fraction(self, owner: np.ndarray) -> float:
        """Share of the segment's real rows in covered partitions."""
        cnt = self.partition_counts()
        tot = int(cnt.sum())
        if tot == 0:
            return 1.0
        return float(cnt[owner >= 0].sum()) / tot

    def ensure_quant(self):
        """Per-shard int8 twins ``(codes, scales, eps)`` of the shard
        blocks, stacked on a leading shard axis and quantized per ``bn``
        tile like the single-device payload. Padding rows quantize to
        exact zeros and stay masked by liveness."""
        if self._quant is None:
            qs = [quantize_rows(self.rows[j], self.bn)
                  for j in range(self.n_shards)]
            self._quant = (np.stack([q.q for q in qs]),
                           np.stack([q.scales for q in qs]),
                           np.stack([q.eps for q in qs]))
        return self._quant

    def nbytes_per_shard(self, *, quantized: bool = False) -> np.ndarray:
        """Resident row-payload bytes each shard holds — its real rows
        (and their tiles), not the uniform padding."""
        dim = int(self.rows.shape[-1])
        rows = self.rows_per_shard.astype(np.int64)
        if not quantized:
            return rows * (4 * dim)
        tiles = -(-rows // self.bn)
        # int8 codes + one f32 scale per tile + one f16 ε per row
        return rows * dim + tiles * 4 + rows * 2


@dataclasses.dataclass
class SIndex:
    """Everything derivable from S alone — computed once, reused forever.

    The S rows are stored in pivot-sorted order (stable lexsort by
    (partition, pivot distance)); tiles cut from the packed rows are
    partition-coherent — the layout the tile schedules
    (``core.schedule``) and the gather kernel rely on. All fields are
    tensors on the index's device.
    """

    config: JoinConfig           # build-time knobs (k, metric, pivots, …)
    pivots: torch.Tensor         # (M, dim) float32
    pivd: torch.Tensor           # (M, M) true pivot-pivot distances
    s_part: torch.Tensor         # (|S|,) int32 partition id, original order
    s_dist: torch.Tensor         # (|S|,) float32 |s, p(s)|, original order
    t_s: SummaryTable            # counts / L / U / pivot-kNN lists (§4.2)
    s_order: torch.Tensor        # (|S|,) int64 sorted position -> original row
    s_sorted: torch.Tensor       # (|S|, dim) rows in (part, dist) order
    s_part_sorted: torch.Tensor  # (|S|,) int32
    s_dist_sorted: torch.Tensor  # (|S|,) float32
    s_ids_sorted: torch.Tensor   # (|S|,) int64 == s_order
    s_inv: torch.Tensor          # (|S|,) int64 original row -> sorted position
    # (M,) float64 per partition, how far its rows may lie outside the
    # pivot's Voronoi cell (L2; ``partition.assignment_excess``); None:
    # exact cells assumed (an index carried in by ``sindex_from_arrays``)
    s_excess: Optional[torch.Tensor] = None
    _tile_stats: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _quant: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _center: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _shards: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.pivots.device

    @property
    def n_s(self) -> int:
        return int(self.s_part.shape[0])

    @property
    def dim(self) -> int:
        return int(self.pivots.shape[1])

    @property
    def n_pivots(self) -> int:
        return int(self.pivots.shape[0])

    def tile_stats(self, bn: int):
        """Per-S-tile Thm-2 statistics ``(sd_min, sd_max, present)`` over
        the packed layout at tile size ``bn`` — query-independent,
        computed once and cached for the index's lifetime."""
        if bn not in self._tile_stats:
            self._tile_stats[bn] = segment_tile_stats(
                self.s_part_sorted, self.s_dist_sorted, self.n_pivots, bn)
        return self._tile_stats[bn]

    def center(self) -> torch.Tensor:
        """The mean of the rows (float64 mean rounded to float32),
        cached: selection in expanded d² runs on rows relative to it, so
        the ‖x‖²·eps cancellation noise shrinks to O(spread²·eps)."""
        if self._center is None:
            self._center = (
                self.s_sorted.to(torch.float64).mean(0).to(torch.float32)
                if self.n_s else torch.zeros(self.dim, device=self.device))
        return self._center

    def ensure_quant(self, bn: Optional[int] = None) -> QuantizedRows:
        """The packed rows' int8 representation at tile size ``bn``
        (default ``config.tile_s``): per-tile symmetric codes + scales +
        per-row error bounds ε (``quant.quantize``), host numpy arrays.
        Built on first use and cached for the index's lifetime."""
        bn = int(self.config.tile_s if bn is None else bn)
        if bn not in self._quant:
            self._quant[bn] = quantize_rows(self.s_sorted.cpu().numpy(), bn)
        return self._quant[bn]

    def shard_packing(self, n_shards: int, bn: Optional[int] = None, *,
                      r: int = 1) -> ShardPacking:
        """This segment's payload laid out over ``n_shards`` mesh shards
        at tile size ``bn`` (default ``config.tile_s``): pivot groups →
        shards by the §5 geometric grouping balanced by partition
        population, rows / ids / tile stats per shard. With ``r > 1``
        each pivot group also lands on ``r − 1`` backup shards (clamped
        at ``n_shards``), heaviest partition first on the least-loaded
        shard not yet holding it. Cached per ``(n_shards, bn, r)`` for
        the index's lifetime; the JAX package's layout, bit for bit."""
        bn = int(self.config.tile_s if bn is None else bn)
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        r = int(r)
        if r < 1:
            raise ValueError(f"replication factor r must be >= 1, got {r}")
        r = min(r, n_shards)
        key = (n_shards, bn, r)
        if key not in self._shards:
            self._shards[key] = self._pack_shards(n_shards, bn, r)
        return self._shards[key]

    def _pack_shards(self, n_shards: int, bn: int, r: int) -> ShardPacking:
        m = self.n_pivots
        pivd = self.pivd.cpu().numpy()
        pcount = self.t_s.counts.cpu().numpy().astype(np.int64)
        part_sorted = self.s_part_sorted.cpu().numpy()
        # geometric grouping refuses more groups than partitions: surplus
        # shards hold no partition (their tiles are never present)
        eff = min(n_shards, m)
        if eff == 1:
            shard_of_part = np.zeros((m,), np.int32)
        else:
            shard_of_part = np.ascontiguousarray(
                G.geometric_grouping(pivd, pcount, eff).astype(np.int32))
        replicas = np.zeros((r, m), np.int32)
        replicas[0] = shard_of_part
        if r > 1:
            load = np.bincount(shard_of_part, weights=pcount,
                               minlength=n_shards).astype(np.int64)
            order = np.argsort(-pcount, kind="stable")
            for c in range(1, r):
                for p in order:
                    held = {int(x) for x in replicas[:c, p]}
                    j = min((s for s in range(n_shards) if s not in held),
                            key=lambda s: (load[s], s))
                    replicas[c, p] = j
                    load[j] += pcount[p]
        # shard j holds every copy of its partitions; boolean selection
        # keeps each block in (partition, dist) packed order
        holds = np.zeros((n_shards, m), bool)
        holds[replicas, np.arange(m)[None, :]] = True
        held_rows = holds[:, part_sorted]              # (n_shards, n_s)
        counts = held_rows.sum(axis=1)
        tiles = max(1, int(-(-counts.max() // bn)))
        rpad = tiles * bn
        rows = np.zeros((n_shards, rpad, self.dim), np.float32)
        gids = np.full((n_shards, rpad), -1, np.int64)
        part = np.full((n_shards, rpad), -1, np.int32)
        dist = np.zeros((n_shards, rpad), np.float32)
        s_sorted = self.s_sorted.cpu().numpy()
        ids_sorted = self.s_ids_sorted.cpu().numpy()
        dist_sorted = self.s_dist_sorted.cpu().numpy()
        for j in range(n_shards):
            sel = held_rows[j]
            nj = int(counts[j])
            rows[j, :nj] = s_sorted[sel]
            gids[j, :nj] = ids_sorted[sel]
            part[j, :nj] = part_sorted[sel]
            dist[j, :nj] = dist_sorted[sel]
        stats = [tuple(x.numpy() for x in segment_tile_stats(
            torch.from_numpy(part[j]), torch.from_numpy(dist[j]), m, bn))
            for j in range(n_shards)]
        return ShardPacking(
            n_shards=n_shards, bn=bn, shard_of_part=shard_of_part,
            tiles_per_shard=tiles, rows=rows, gids_local=gids, part=part,
            dist=dist, rows_per_shard=counts.astype(np.int64),
            sd_min=np.stack([st[0] for st in stats]),
            sd_max=np.stack([st[1] for st in stats]),
            present=np.stack([st[2] for st in stats]),
            r=r, replicas_of_part=replicas)

    def nbytes_resident(self, *, quantized: Optional[bool] = None,
                        n_shards: Optional[int] = None) -> int:
        """Device-resident bytes of the index's row payload: the fp32
        packed rows, or — quantized — the int8 codes + per-tile scales +
        per-row ε. The default mode follows ``config.quantize``. With
        ``n_shards``: the **largest shard's** row-payload bytes under
        :meth:`shard_packing` — what must fit one device when the index
        runs sharded."""
        if quantized is None:
            quantized = self.config.quantize != "none"
        if n_shards is not None and int(n_shards) > 0:
            sp = self.shard_packing(int(n_shards))
            return int(sp.nbytes_per_shard(quantized=quantized).max())
        if not quantized:
            return int(self.s_sorted.numel() * self.s_sorted.element_size())
        return int(self.ensure_quant().nbytes())

    def replica_mask_sorted(self, lb_group: torch.Tensor,
                            g: int) -> torch.Tensor:
        """Theorem 6 membership over the packed row layout: which S rows
        ship to group ``g`` under a query plan's ``lb_group``."""
        return self.s_dist_sorted >= lb_group[
            self.s_part_sorted.to(torch.int64), g]

    def rows_for_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather S rows by original (global) row id from the packed
        layout; negative ids yield arbitrary rows (callers mask them)."""
        pos = self.s_inv[torch.clamp(ids, 0, self.n_s - 1)]
        return self.s_sorted[pos]


def build_index(
    s,
    config: Optional[JoinConfig] = None,
    *,
    pivot_data: Optional[np.ndarray] = None,
    pivots: Optional[np.ndarray] = None,
    pivot_strategy: Optional[str] = None,
    quantize: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> SIndex:
    """S-side phase 1, once: pivot selection, Voronoi assignment, T_S,
    and the pivot-sorted row packing, on ``device``.

    ``pivot_data`` chooses where pivots are sampled from (default: S;
    the one-shot ``knn_join`` passes its R, the paper's preprocessing);
    ``pivots`` overrides selection entirely. ``pivot_strategy``
    overrides the config's §4.1 strategy. Selection draws from numpy
    ``default_rng(config.seed)`` in the JAX package's order, so both
    packages pick the same pivots from the same data.
    ``quantize="int8"`` also attaches the packed rows' int8 twin
    (:meth:`SIndex.ensure_quant`) and stamps the mode into the config.
    """
    dev = resolve_device(device)
    config = config or JoinConfig()
    if pivot_strategy is not None and pivot_strategy != config.pivot_strategy:
        config = dataclasses.replace(config, pivot_strategy=pivot_strategy)
    if quantize is not None and quantize != config.quantize:
        config = dataclasses.replace(config, quantize=quantize)
    s_t = as_float32_rows(s, what="S rows").to(dev)
    if pivots is None:
        src = (s_t.cpu().numpy() if pivot_data is None
               else np.asarray(pivot_data))
        m = min(config.n_pivots, src.shape[0])
        pivots = select_pivots(
            src, m, config.pivot_strategy, sample=config.pivot_sample,
            n_sets=config.pivot_candidate_sets, seed=config.seed,
            device=dev)
    piv = torch.as_tensor(np.ascontiguousarray(pivots, np.float32),
                          device=dev)
    s_part, s_dist, t_s, order = assign_and_summarize(
        s_t, piv, k=config.k, metric=config.metric, return_order=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=dev)
    index = SIndex(
        config=config, pivots=piv,
        pivd=B.pivot_distance_matrix(piv, config.metric),
        s_part=s_part, s_dist=s_dist, t_s=t_s, s_order=order,
        s_sorted=s_t[order].contiguous(),
        s_part_sorted=s_part[order].contiguous(),
        s_dist_sorted=s_dist[order].contiguous(),
        s_ids_sorted=order.clone(), s_inv=inv,
        s_excess=(assignment_excess(s_t, piv, s_part)
                  if config.metric == "l2" else None))
    if config.quantize == "int8":
        index.ensure_quant(config.tile_s)
    return index


_ARRAY_DTYPES = {
    "pivots": torch.float32, "pivd": torch.float32, "s_part": torch.int32,
    "s_dist": torch.float32, "t_s.counts": torch.int32,
    "t_s.lower": torch.float32, "t_s.upper": torch.float32,
    "t_s.knn_dists": torch.float32, "s_order": torch.int64,
    "s_sorted": torch.float32, "s_part_sorted": torch.int32,
    "s_dist_sorted": torch.float32, "s_ids_sorted": torch.int64,
    "s_inv": torch.int64,
}


def sindex_from_arrays(arrays: Dict[str, np.ndarray], config: JoinConfig,
                       device: Union[str, torch.device] = "cuda") -> SIndex:
    """The port's ``SIndex`` from the numpy fields of an index built
    elsewhere (the JAX package's ``SIndex``: ``pivots``, ``pivd``,
    ``s_part``, ``s_dist``, ``t_s.counts/lower/upper/knn_dists``,
    ``s_order``, ``s_sorted``, ``s_part_sorted``, ``s_dist_sorted``,
    ``s_ids_sorted``, ``s_inv``) — the index-state counterpart of
    carrying weights across, so both packages serve from one index.
    A quantized index also carries its ``QuantizedRows`` fields as
    ``quant.q``, ``quant.scales``, ``quant.eps`` (tile size
    ``config.tile_s``)."""
    dev = resolve_device(device)
    missing = sorted(set(_ARRAY_DTYPES) - set(arrays))
    if missing:
        raise KeyError(f"sindex_from_arrays: missing fields {missing}")
    t = {name: torch.tensor(np.asarray(arrays[name]), device=dev).to(dtype)
         for name, dtype in _ARRAY_DTYPES.items()}
    index = SIndex(
        config=config, pivots=t["pivots"], pivd=t["pivd"],
        s_part=t["s_part"], s_dist=t["s_dist"],
        t_s=SummaryTable(counts=t["t_s.counts"], lower=t["t_s.lower"],
                         upper=t["t_s.upper"],
                         knn_dists=t["t_s.knn_dists"]),
        s_order=t["s_order"], s_sorted=t["s_sorted"],
        s_part_sorted=t["s_part_sorted"], s_dist_sorted=t["s_dist_sorted"],
        s_ids_sorted=t["s_ids_sorted"], s_inv=t["s_inv"])
    if "quant.q" in arrays:
        bn = int(config.tile_s)
        qr = QuantizedRows(
            q=np.ascontiguousarray(arrays["quant.q"], np.int8),
            scales=np.ascontiguousarray(arrays["quant.scales"], np.float32),
            eps=np.ascontiguousarray(arrays["quant.eps"], np.float16),
            bn=bn, n_rows=index.n_s)
        if (qr.q.shape != (max(1, -(-index.n_s // bn)) * bn, index.dim)
                or qr.q.shape[0] != qr.n_tiles * bn
                or qr.eps.shape != (qr.q.shape[0],)):
            raise ValueError(
                f"sindex_from_arrays: quant.q {qr.q.shape}, quant.scales "
                f"{qr.scales.shape}, quant.eps {qr.eps.shape} are not a "
                f"quantization of {index.n_s} rows at tile_s={bn}")
        index._quant[bn] = qr
    elif config.quantize == "int8":
        index.ensure_quant(config.tile_s)
    return index


@dataclasses.dataclass
class QueryPlan:
    """Everything the join needs that depends on the query batch (paper
    §4.3/§5): assignment, θ, the LB matrices and the grouping — tensors
    on the index's device."""

    config: JoinConfig
    r_part: torch.Tensor         # (|R|,) int32
    r_dist: torch.Tensor         # (|R|,) float32
    t_r: SummaryTable
    theta: torch.Tensor          # (M,)       Eq. 6 / Algorithm 1
    lb: torch.Tensor             # (M_s, M_r) Cor. 2
    groups: torch.Tensor         # (M,) int32 group id per R-partition
    lb_group: torch.Tensor       # (M_s, N)   Thm 6

    @property
    def n_r(self) -> int:
        return int(self.r_part.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.lb_group.shape[1])

    def group_of_r(self) -> torch.Tensor:
        return self.groups[self.r_part.to(torch.int64)]


def plan_queries(r, index: SIndex,
                 config: Optional[JoinConfig] = None) -> QueryPlan:
    """R-side planning for one query batch against a resident index:
    assignment (the nearest-pivot kernel on the card), θ and the LB
    matrix as device ops, grouping on the host."""
    config = config or index.config
    if config.metric != index.config.metric:
        raise ValueError(
            f"metric={config.metric!r} but the index was built with "
            f"{index.config.metric!r}; pivd/T_S bounds do not transfer "
            f"between metrics — rebuild the index")
    r = as_float32_rows(r, what="R rows").to(index.device)
    m = index.n_pivots
    if index.t_s.knn_dists is None:
        raise ValueError("index was built without T_S pivot-kNN lists")
    r_part, r_dist = assign_to_pivots(r, index.pivots, metric=config.metric)
    t_r = build_summary(r_part, r_dist, m)
    theta, lb = B.theta_and_lb(index.pivd, t_r, index.t_s, config.k)
    n_groups = min(config.n_groups, m)
    groups = torch.as_tensor(G.group_partitions(
        config.grouping, index.pivd, t_r, n_groups, lb=lb, t_s=index.t_s),
        device=index.device)
    return QueryPlan(
        config=config, r_part=r_part, r_dist=r_dist, t_r=t_r, theta=theta,
        lb=lb, groups=groups,
        lb_group=B.group_lower_bounds(lb, groups, n_groups))
