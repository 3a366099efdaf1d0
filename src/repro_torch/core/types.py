"""Shared types for the PGBJ kNN-join core (PyTorch port).

The same dataclasses as the JAX package's ``core.types``, so a config or
a stats record reads the same in both packages. Results stay numpy:
``JoinResult`` holds ``(int64 ids, float32 distances)`` arrays.

Conventions
-----------
* Datasets are dense float arrays of shape ``(n, dim)``.
* ``M`` is the number of pivots; partitions are indexed ``0..M-1``.
* All *bounds* (Theorems 1-6 of the paper) operate on true Euclidean
  distances, never squared distances — the triangle inequality the paper
  leans on does not survive squaring. Squared distances are used only
  inside dense tile computations where monotonicity suffices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Configuration of one kNN-join execution (paper §4-§5 knobs)."""

    k: int = 10
    metric: str = "l2"              # l2 | l1 | linf  (paper §2.1)
    # §4.1 preprocessing
    n_pivots: int = 64
    pivot_strategy: str = "random"  # random | farthest | kmeans
    pivot_sample: int = 4096        # sample size for farthest/kmeans selection
    pivot_candidate_sets: int = 8   # T random sets for random selection
    # §5 grouping
    n_groups: int = 8
    grouping: str = "geometric"     # geometric | greedy | none
    # reducer engine
    tile_r: int = 128               # R rows per distance tile
    tile_s: int = 512               # S rows per distance tile
    use_tile_pruning: bool = True   # Cor. 1 / Thm 2 adapted to tile masking
    # auto → "pruned"/"dense" per use_tile_pruning; "gather" runs the
    # compacted schedule (core.schedule) through the scheduled gather
    # kernel on the card, its plain version on the CPU
    reducer: str = "auto"           # auto | dense | pruned | gather
    # streaming engine (core.stream): R micro-batch rows per plan+join
    # round; 0 = one-shot (whole query set in a single batch)
    batch_size: int = 0
    # quantized tier (repro_torch.quant): "int8" attaches per-tile
    # symmetric int8 codes + per-row error bounds ε to every built index
    # and routes knn_join(quantized=True) & friends through the two-tier
    # coarse-scan → exact-re-rank engine (L2 only, results bitwise the
    # fp32 oracle's)
    quantize: str = "none"          # none | int8
    # coarse shortlist over-fetch: k + quant_slack candidates survive
    # the int8 pass into the exact fp32 re-rank (rounded up to a power
    # of two); -1 = auto (shortlist max(pow2(4k), 128))
    quant_slack: int = -1
    seed: int = 0

    def __post_init__(self):
        if self.pivot_strategy not in ("random", "farthest", "kmeans"):
            raise ValueError(f"unknown pivot strategy {self.pivot_strategy!r}")
        if self.grouping not in ("geometric", "greedy", "none"):
            raise ValueError(f"unknown grouping {self.grouping!r}")
        if self.reducer not in ("auto", "dense", "pruned", "gather"):
            raise ValueError(f"unknown reducer {self.reducer!r}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.batch_size < 0:
            raise ValueError("batch_size must be >= 0")
        if self.metric not in ("l2", "l1", "linf"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}")
        if self.quantize != "none" and self.metric != "l2":
            raise ValueError(
                f"quantize={self.quantize!r} requires metric='l2' (the "
                f"int8 coarse kernel is the Euclidean lowering); got "
                f"{self.metric!r} — drop quantize or use the fp32 host "
                f"engines")
        if self.quant_slack < -1:
            raise ValueError("quant_slack must be >= 0, or -1 for auto")

    @property
    def resolved_reducer(self) -> str:
        """The engine "auto" selects (back-compat with use_tile_pruning)."""
        if self.reducer != "auto":
            return self.reducer
        return "pruned" if self.use_tile_pruning else "dense"


@dataclasses.dataclass
class SummaryTable:
    """Per-partition statistics — the paper's summary tables T_R / T_S (§4.2).

    Attributes
    ----------
    counts:    (M,) int32   — |P_i|
    lower:     (M,) float32 — L(P_i) = min object->pivot distance (+inf if empty)
    upper:     (M,) float32 — U(P_i) = max object->pivot distance (0 if empty)
    knn_dists: (M, k) float32 or None — for T_S only: |p_i, o| of the k
               objects of P_i^S nearest to p_i, ascending, padded with +inf.
               (``p_i.d_j`` in the paper's Figure 3.)
    """

    counts: np.ndarray
    lower: np.ndarray
    upper: np.ndarray
    knn_dists: Optional[np.ndarray] = None

    @property
    def n_partitions(self) -> int:
        return int(self.counts.shape[0])


@dataclasses.dataclass
class JoinStats:
    """Instrumentation mirroring the paper's reported metrics (§6)."""

    n_r: int = 0
    n_s: int = 0
    # shuffling cost:  |R| + sum of replicas of S  (paper §3)
    replicas_s: int = 0
    # of object pairs whose distance was actually computed (Eq. 13 numerator)
    pairs_computed: int = 0
    # pivot-distance computations (included in selectivity per paper §6)
    pivot_pairs_computed: int = 0
    # tile bookkeeping for the tiled engines
    tiles_total: int = 0
    tiles_visited: int = 0
    # streaming engine: planned+joined R micro-batches (0 = one-shot path)
    n_batches: int = 0
    # sharded megastep (core.sharded): mesh shards the batch fanned over
    # (0 = single-device path)
    n_shards: int = 0
    # mutable segmented index (core.segments): live segments fanned over
    # at query time (sealed deltas + write buffer), tombstoned rows
    # masked during the merge, and total time spent in compact()
    n_segments: int = 0
    n_tombstones: int = 0
    compact_time_s: float = 0.0
    # quantized tier: queries whose coarse-pass certification failed
    # and re-ran through the fp32 host oracle (exactness is
    # unconditional; this counts how often the int8 shortlist alone
    # could not prove it)
    n_quant_fallback: int = 0
    # quantized-tier routing decisions (engine and autotune): the mode
    # the engine resolved ("int8" two-tier or "fp32" tuned fallback;
    # "" when no quant engine ran), whether a tuning-table entry drove
    # it, the shortlist size in force, and how
    # many queries each exact-re-rank variant handled — the fused
    # device-resident gather vs the low-memory host-gather round-trip
    quant_mode: str = ""
    quant_autotuned: bool = False
    quant_mp: int = 0
    n_resident_rerank: int = 0
    n_host_rerank: int = 0
    # serving degradation (serve.scheduler): queries answered by the
    # certified-approximate coarse-only path instead of the exact
    # engine, and the minimum per-query certified recall lower bound
    # across them (1.0 when nothing degraded — the exact paths always
    # have recall 1)
    n_degraded: int = 0
    recall_bound: float = 1.0
    # sharded failover (core.sharded): shards the serving view currently
    # marks failed, and the certified fraction of resident rows still in
    # covered pivot groups (1.0 = every populated group has a live
    # replica; < 1.0 only on the no-replica degraded-coverage path, in
    # which case recall_bound above carries the per-batch minimum of the
    # sound per-query certificates)
    n_failed_shards: int = 0
    coverage_bound: float = 1.0
    # certified K-G routes (core.certify): queries whose float32 run
    # could not be certified and re-ran exactly (ROADMAP C15)
    n_exact_rerun: int = 0

    def merged(self, other: "JoinStats") -> "JoinStats":
        """Fold ``other`` (a later attempt / retried / failed-over batch
        of the same serving stream) into a new aggregate — the fix for
        stats from retries silently overwriting each other when one
        shared ``JoinStats`` is threaded through every engine call.

        Per-field semantics:

        * **counters sum** — ``n_r``, ``replicas_s``,
          ``pairs_computed``/``pivot_pairs_computed``,
          ``tiles_total``/``tiles_visited``, ``n_batches``,
          ``n_quant_fallback``, ``n_resident_rerank``/``n_host_rerank``,
          ``n_degraded``, ``n_exact_rerun``, and the ``compact_time_s`` accumulator
          (selectivity/tile-selectivity stay meaningful as
          work-weighted aggregates);
        * **sizes keep the max** — ``n_s`` is the S side every attempt
          joined against, not work performed: summing it across retries
          of the *same* index would deflate the aggregate selectivity
          (Σpairs / (Σn_r · max n_s) is the work-weighted mean);
        * **degradation keeps the worst** — ``recall_bound`` and
          ``coverage_bound`` take the min (a sound bound for the union
          of answers is the worst per-batch bound),
          ``n_failed_shards`` the max (it is a view size, not a rate);
        * **routing fields keep the last writer** — ``quant_mode`` /
          ``quant_autotuned`` / ``quant_mp`` describe which engine the
          *most recent* batch ran on, ``n_shards`` the mesh it ran
          over, ``n_segments``/``n_tombstones`` the index snapshot it
          saw; ``other`` wins whenever it actually stamped them.
        """
        out = JoinStats(
            n_r=self.n_r + other.n_r,
            n_s=max(self.n_s, other.n_s),
            replicas_s=self.replicas_s + other.replicas_s,
            pairs_computed=self.pairs_computed + other.pairs_computed,
            pivot_pairs_computed=(self.pivot_pairs_computed
                                  + other.pivot_pairs_computed),
            tiles_total=self.tiles_total + other.tiles_total,
            tiles_visited=self.tiles_visited + other.tiles_visited,
            n_batches=self.n_batches + other.n_batches,
            compact_time_s=self.compact_time_s + other.compact_time_s,
            n_quant_fallback=(self.n_quant_fallback
                              + other.n_quant_fallback),
            n_resident_rerank=(self.n_resident_rerank
                               + other.n_resident_rerank),
            n_host_rerank=self.n_host_rerank + other.n_host_rerank,
            n_degraded=self.n_degraded + other.n_degraded,
            recall_bound=min(self.recall_bound, other.recall_bound),
            coverage_bound=min(self.coverage_bound, other.coverage_bound),
            n_failed_shards=max(self.n_failed_shards,
                                other.n_failed_shards),
            n_shards=other.n_shards or self.n_shards,
            n_exact_rerun=self.n_exact_rerun + other.n_exact_rerun,
        )
        # quant routing: the trio travels together (autotuned=False is a
        # meaningful stamp once a mode is set)
        if other.quant_mode:
            out.quant_mode = other.quant_mode
            out.quant_autotuned = other.quant_autotuned
            out.quant_mp = other.quant_mp
        else:
            out.quant_mode = self.quant_mode
            out.quant_autotuned = self.quant_autotuned
            out.quant_mp = self.quant_mp
        # index snapshot: tombstones ride with the segment count (0
        # tombstones under live segments is a real observation)
        if other.n_segments:
            out.n_segments = other.n_segments
            out.n_tombstones = other.n_tombstones
        else:
            out.n_segments = self.n_segments
            out.n_tombstones = self.n_tombstones
        return out

    @property
    def selectivity(self) -> float:
        """Computation selectivity, Eq. 13 (pivot distances included)."""
        denom = float(self.n_r) * float(self.n_s)
        if denom == 0:
            return 0.0
        return (self.pairs_computed + self.pivot_pairs_computed) / denom

    @property
    def shuffle_tuples(self) -> int:
        return self.n_r + self.replicas_s

    @property
    def tile_selectivity(self) -> float:
        if self.tiles_total == 0:
            return 0.0
        return self.tiles_visited / self.tiles_total


@dataclasses.dataclass
class JoinResult:
    """kNN-join output:  indices into S and distances, per object of R.

    Indices are **int64** (every engine returns int64; segment-offset
    ids from the mutable index overflow int32 by design): row ids into
    S for a static ``SIndex``, global segment-offset ids for a
    ``core.segments.MutableIndex`` (stable until ``compact``). ``-1``
    marks padding slots (fewer than k live candidates), always paired
    with a ``+inf`` distance.
    """

    indices: np.ndarray    # (|R|, k) int64 — row ids into S, by ascending distance
    distances: np.ndarray  # (|R|, k) float32 — true (non-squared) distances
    stats: JoinStats
