"""PGBJ kNN joins (Lu et al., "Efficient Processing of k Nearest Neighbor
Joins using MapReduce") in PyTorch, on hand-written CUDA kernels for
NVIDIA Hopper.

A port of the JAX package ``repro``, which stays as the reference. It
imports torch and numpy only. Entry points take ``device=`` and default
to ``"cuda"``; pass ``device="cpu"`` to run the kernels' plain PyTorch
versions.
"""
from . import core, kernels, obs, quant, serve
from .core import (JoinConfig, JoinResult, JoinStats, MegastepEngine,
                   MutableIndex, Segment, SIndex, StreamJoinEngine,
                   brute_force_knn, build_index, hbrj_join, knn_join,
                   knn_join_batched, pbj_join, plan_queries,
                   sindex_from_arrays)
from .data import clustered_like, expand_dataset, forest_like, osm_like
from .quant.engine import QuantMegastepEngine

__all__ = ["core", "kernels", "obs", "quant", "serve", "JoinConfig",
           "JoinResult", "JoinStats", "MegastepEngine", "MutableIndex",
           "QuantMegastepEngine", "Segment", "SIndex", "StreamJoinEngine",
           "brute_force_knn", "build_index", "clustered_like",
           "expand_dataset", "forest_like", "hbrj_join", "knn_join",
           "knn_join_batched", "osm_like", "pbj_join", "plan_queries",
           "sindex_from_arrays"]
