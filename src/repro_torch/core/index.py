"""Build-once S-index — PyTorch port of the JAX package's
``core.index`` (the static ``SIndex`` and ``build_index``).

``SIndex`` holds everything derivable from S alone, as tensors on one
device: pivots, the pivot-distance matrix, S's partition assignment
and summary table T_S, and the S rows packed in pivot-sorted
(partition, pivot distance) order, so every tile cut from the packed
rows is partition-coherent. The per-batch query planner
(``plan_queries``), shard packing and the quantized tier come with later
slices (ROADMAP Queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .bounds import pivot_distance_matrix
from .partition import assign_and_summarize
from .pivots import select_pivots
from .schedule import segment_tile_stats
from .types import JoinConfig, SummaryTable

__all__ = ["SIndex", "build_index", "sindex_from_arrays", "as_float32_rows"]

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
        f"{feature} is not ported yet (ROADMAP Queue {item}); the port "
        f"serves a static SIndex through the megastep")


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
    _tile_stats: dict = dataclasses.field(
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
    device: Union[str, torch.device] = "cuda",
) -> SIndex:
    """S-side phase 1, once: pivot selection, Voronoi assignment, T_S,
    and the pivot-sorted row packing, on ``device``.

    ``pivot_data`` chooses where pivots are sampled from (default: S);
    ``pivots`` overrides selection entirely. ``pivot_strategy``
    overrides the config's §4.1 strategy. Selection draws from numpy
    ``default_rng(config.seed)`` in the JAX package's order, so both
    packages pick the same pivots from the same data.
    """
    dev = resolve_device(device)
    config = config or JoinConfig()
    if config.quantize != "none":
        raise not_ported(f"quantize={config.quantize!r}", "A4")
    if pivot_strategy is not None and pivot_strategy != config.pivot_strategy:
        config = dataclasses.replace(config, pivot_strategy=pivot_strategy)
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
    return SIndex(
        config=config, pivots=piv,
        pivd=pivot_distance_matrix(piv, config.metric),
        s_part=s_part, s_dist=s_dist, t_s=t_s, s_order=order,
        s_sorted=s_t[order].contiguous(),
        s_part_sorted=s_part[order].contiguous(),
        s_dist_sorted=s_dist[order].contiguous(),
        s_ids_sorted=order.clone(), s_inv=inv)


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
    carrying weights across, so both packages serve from one index."""
    dev = resolve_device(device)
    missing = sorted(set(_ARRAY_DTYPES) - set(arrays))
    if missing:
        raise KeyError(f"sindex_from_arrays: missing fields {missing}")
    if config.quantize != "none":
        raise not_ported(f"quantize={config.quantize!r}", "A4")
    t = {name: torch.tensor(np.asarray(arrays[name]), device=dev).to(dtype)
         for name, dtype in _ARRAY_DTYPES.items()}
    return SIndex(
        config=config, pivots=t["pivots"], pivd=t["pivd"],
        s_part=t["s_part"], s_dist=t["s_dist"],
        t_s=SummaryTable(counts=t["t_s.counts"], lower=t["t_s.lower"],
                         upper=t["t_s.upper"],
                         knn_dists=t["t_s.knn_dists"]),
        s_order=t["s_order"], s_sorted=t["s_sorted"],
        s_part_sorted=t["s_part_sorted"], s_dist_sorted=t["s_dist_sorted"],
        s_ids_sorted=t["s_ids_sorted"], s_inv=t["s_inv"])
