"""PGBJ kNN join, PyTorch port — the JAX package's ``core``: the
build-once ``SIndex``, the mutable segmented ``MutableIndex``, the
per-batch planner (``plan_queries``), the host-planned join
(``knn_join`` → ``execute_join``), the fused megastep, its sharded form
over a device mesh and the streaming engine. The paper's MapReduce
mapping over a mesh (the shuffle join and phase 1) is in
``core.distributed``."""
from .types import JoinConfig, JoinResult, JoinStats, SummaryTable
from .pivots import select_pivots
from .partition import assign_to_pivots, assign_and_summarize, build_summary
from .bounds import (compute_theta, group_lower_bounds, hyperplane_distances,
                     pad_theta, pivot_distance_matrix,
                     replication_lower_bounds, ring_bounds, theta_and_lb)
from .grouping import (geometric_grouping, greedy_grouping, group_partitions,
                       replication_count_exact, replication_count_partitions)
from .schedule import (TileSchedule, build_tile_schedule, compact_visit_mask,
                       compact_visits, schedule_for_group, segment_tile_stats,
                       visit_mask)
from .index import (QueryPlan, ShardPacking, SIndex, as_float32_rows,
                    build_index, plan_queries, sindex_from_arrays)
from .join import (join_group, join_group_dense, join_group_gather,
                   join_group_pruned, topk_merge)
from .api import JoinPlan, execute_join, knn_join, plan_join
from .megastep import JoinHandle, MegastepEngine
from .sharded import ShardedMegastepEngine
from .stream import StreamJoinEngine, StreamJoinState, knn_join_batched
from .segments import MutableIndex, Segment
from .metrics import (canonical_gathered, canonical_topk, from_cmp,
                      gathered_dist)
from .baselines import brute_force_knn, hbrj_join, pbj_join

__all__ = [
    "JoinConfig", "JoinResult", "JoinStats", "SummaryTable",
    "select_pivots", "assign_to_pivots", "assign_and_summarize",
    "build_summary",
    "compute_theta", "group_lower_bounds", "hyperplane_distances",
    "pad_theta", "pivot_distance_matrix", "replication_lower_bounds",
    "ring_bounds", "theta_and_lb",
    "geometric_grouping", "greedy_grouping", "group_partitions",
    "replication_count_exact", "replication_count_partitions",
    "TileSchedule", "build_tile_schedule", "compact_visit_mask",
    "compact_visits", "schedule_for_group", "segment_tile_stats",
    "visit_mask",
    "QueryPlan", "ShardPacking", "SIndex", "as_float32_rows", "build_index",
    "plan_queries", "sindex_from_arrays",
    "join_group", "join_group_dense", "join_group_gather",
    "join_group_pruned", "topk_merge",
    "JoinPlan", "execute_join", "knn_join", "plan_join",
    "JoinHandle", "MegastepEngine", "ShardedMegastepEngine",
    "StreamJoinEngine", "StreamJoinState", "knn_join_batched",
    "MutableIndex", "Segment",
    "canonical_gathered", "canonical_topk", "from_cmp", "gathered_dist",
    "brute_force_knn", "hbrj_join", "pbj_join",
]
