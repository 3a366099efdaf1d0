"""PGBJ kNN join, PyTorch port — the serving path of the JAX package's
``core`` (build-once ``SIndex`` → fused megastep → batched join)."""
from .types import JoinConfig, JoinResult, JoinStats, SummaryTable
from .pivots import select_pivots
from .partition import assign_to_pivots, assign_and_summarize
from .bounds import pad_theta, pivot_distance_matrix
from .schedule import compact_visits, segment_tile_stats, visit_mask
from .index import SIndex, as_float32_rows, build_index, sindex_from_arrays
from .megastep import JoinHandle, MegastepEngine
from .stream import StreamJoinEngine, StreamJoinState, knn_join_batched
from .metrics import canonical_gathered, canonical_topk, gathered_dist
from .baselines import brute_force_knn

__all__ = [
    "JoinConfig", "JoinResult", "JoinStats", "SummaryTable",
    "select_pivots", "assign_to_pivots", "assign_and_summarize",
    "pad_theta", "pivot_distance_matrix",
    "compact_visits", "segment_tile_stats", "visit_mask",
    "SIndex", "as_float32_rows", "build_index", "sindex_from_arrays",
    "JoinHandle", "MegastepEngine",
    "StreamJoinEngine", "StreamJoinState", "knn_join_batched",
    "canonical_gathered", "canonical_topk", "gathered_dist",
    "brute_force_knn",
]
