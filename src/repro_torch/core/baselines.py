"""The baselines of the paper's §3 and §6 — PyTorch port of the JAX
package's ``core.baselines``: the brute-force oracle (L2, L1 and L∞),
H-BRJ (Zhang et al., EDBT'12) and PBJ (PGBJ's bounds without grouping).

H-BRJ's reducers use R-trees in the original; each (R_i, S_j) block join
here is a blocked brute-force top-k (``join.join_group_dense``), the
compute its shuffle pattern implies, as in the JAX package. Its
selection distances are taken in float64 (``metrics.select_dist``): a
random block spreads over the whole dataset, and the JAX package's
float32 expansion misses true neighbours on OSM-like map coordinates
(ROADMAP C15). Shuffle accounting follows §3: √N·|S| + (√N − 1)·|R|
replicas for job 1. Both joins are Python loops over blocks and tiles,
as in the reference: on the card their speed is set by launch overhead,
which is the baseline the paper compares against.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import bounds as B
from .join import join_group_dense, join_group_pruned, topk_merge
from .metrics import canonical_topk
from .partition import (assign_and_summarize, assignment_excess,
                        build_summary)
from .pivots import select_pivots
from .types import JoinConfig, JoinResult, JoinStats

__all__ = ["brute_force_knn", "hbrj_join", "pbj_join"]

# the L1 / L∞ oracle's float64 difference tile, (rows, |S|, d), is cut to
# at most this many bytes
DIFF_TILE_BYTES = 1 << 30


def brute_force_knn(
    r: np.ndarray, s: np.ndarray, k: int, *, tile_r: int = 256,
    metric: str = "l2", device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact oracle: (dists float32, ids int64), ascending. O(|R||S|).

    Selection runs in float64 (an oracle must out-resolve the engines'
    float32 noise — on data far from the origin real kNN gaps can sit
    below f32 cancellation error); reported distances then go through
    the same canonical float32 chain (`metrics.canonical_topk`) the
    engines emit, so oracle and engine outputs compare directly. L1 and
    L∞ build a float64 difference tile of (rows, |S|, d), whose rows are
    cut so that it holds at most ``DIFF_TILE_BYTES``; the cut changes no
    result.
    """
    if metric not in ("l2", "l1", "linf"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = resolve_device(device)
    r32 = torch.as_tensor(np.asarray(r, np.float32), device=dev)
    s32 = torch.as_tensor(np.asarray(s, np.float32), device=dev)
    s64 = s32.to(torch.float64)
    if metric == "l2":
        s2 = (s64 * s64).sum(-1)
    else:
        row_bytes = 8 * s64.shape[0] * max(1, s64.shape[1])
        tile_r = max(1, min(tile_r, DIFF_TILE_BYTES // row_bytes))
    out_i = torch.empty((r32.shape[0], k), dtype=torch.int64, device=dev)
    for lo in range(0, r32.shape[0], tile_r):
        q = r32[lo:lo + tile_r].to(torch.float64)
        if metric == "l2":
            d = (q * q).sum(-1)[:, None] + s2[None, :] - 2.0 * (q @ s64.T)
        else:
            diff = (q[:, None, :] - s64[None, :, :]).abs_()
            d = diff.sum(-1) if metric == "l1" else diff.amax(-1)
            del diff
        dk, part = torch.topk(d, k, dim=1, largest=False)
        order = torch.argsort(dk, dim=1, stable=True)
        out_i[lo:lo + tile_r] = torch.take_along_dim(part, order, dim=1)
    neigh = s32[out_i.clamp(0, s32.shape[0] - 1)]
    out_d, out_i = canonical_topk(r32, out_i, neigh, metric)
    return out_d.cpu().numpy(), out_i.cpu().numpy()


def _blocks(rng: np.random.Generator, root: int, n_r: int, n_s: int):
    """The random √N-way split of R and then of S (the JAX package's
    draw order, so every row lands in the same block)."""
    return rng.integers(0, root, n_r), rng.integers(0, root, n_s)


def _empty(n: int, k: int, dev):
    return (torch.full((n, k), float("inf"), device=dev),
            torch.full((n, k), -1, dtype=torch.int64, device=dev))


def _finish(r32, s32, out_i, stats) -> JoinResult:
    """The canonical distances of the merged ids, as every engine
    reports them."""
    neigh = s32[out_i.clamp(0, s32.shape[0] - 1)]
    d, i = canonical_topk(r32, out_i, neigh)
    return JoinResult(indices=i.cpu().numpy(), distances=d.cpu().numpy(),
                      stats=stats)


def hbrj_join(
    r: np.ndarray, s: np.ndarray, k: int, *, n_reducers: int = 16,
    seed: int = 0, device: Union[str, torch.device] = "cuda",
) -> JoinResult:
    """H-BRJ: a random √N × √N block join, then the merge job."""
    dev = resolve_device(device)
    r = np.asarray(r, np.float32)
    s = np.asarray(s, np.float32)
    root = max(1, math.isqrt(n_reducers))
    r_blk, s_blk = _blocks(np.random.default_rng(seed), root, r.shape[0],
                           s.shape[0])
    stats = JoinStats(n_r=r.shape[0], n_s=s.shape[0])
    # job-1 shuffle: each R_i goes to √N reducers, each S_j to √N reducers
    stats.replicas_s = root * s.shape[0] + (root - 1) * r.shape[0]
    r32 = torch.as_tensor(r, device=dev)
    s32 = torch.as_tensor(s, device=dev)
    s_ids = torch.arange(s.shape[0], dtype=torch.int64, device=dev)
    out_i = torch.full((r.shape[0], k), -1, dtype=torch.int64, device=dev)
    s_sel = [torch.as_tensor(np.where(s_blk == j)[0], device=dev)
             for j in range(root)]
    for i in range(root):
        r_sel = torch.as_tensor(np.where(r_blk == i)[0], device=dev)
        if r_sel.numel() == 0:
            continue
        bd, bi = _empty(r_sel.numel(), k, dev)
        rr = r32[r_sel]
        for sj in s_sel:
            if sj.numel() == 0:
                continue
            gd, gi = join_group_dense(rr, s32[sj], s_ids[sj],
                                      min(k, sj.numel()), stats=stats)
            # merge job (the 2nd MapReduce): combine partial top-k
            bd, bi = topk_merge(bd, bi, gd ** 2, gi, k)
        out_i[r_sel] = bi
    return _finish(r32, s32, out_i, stats)


def pbj_join(
    r: np.ndarray, s: np.ndarray, k: int,
    config: JoinConfig | None = None, *, n_reducers: int = 16,
    device: Union[str, torch.device] = "cuda",
) -> JoinResult:
    """PBJ: PGBJ's pivots and bounds in H-BRJ's ungrouped √N × √N
    framework. R and S are each split at random into √N subsets; a
    reducer joins (R_i, S_j) with a θ built from the S objects it
    received (paper §6: "without grouping ... randomness results in a
    loose distance bound"), then a merge job combines the partials."""
    dev = resolve_device(device)
    config = config or JoinConfig(k=k)
    r = np.asarray(r, np.float32)
    s = np.asarray(s, np.float32)
    root = max(1, math.isqrt(n_reducers))
    rng = np.random.default_rng(config.seed)
    m = min(config.n_pivots, r.shape[0])
    piv_np = select_pivots(r, m, config.pivot_strategy,
                           sample=config.pivot_sample, seed=config.seed,
                           device=dev)
    r32 = torch.as_tensor(r, device=dev)
    s32 = torch.as_tensor(s, device=dev)
    pivots = torch.as_tensor(piv_np, device=dev)
    r_part, _, t_r = assign_and_summarize(r32, pivots)
    s_part, s_dist, _ = assign_and_summarize(s32, pivots, k=k)
    s_excess = assignment_excess(s32, pivots, s_part)
    pivd = B.pivot_distance_matrix(pivots)

    stats = JoinStats(n_r=r.shape[0], n_s=s.shape[0])
    stats.pivot_pairs_computed += (r.shape[0] + s.shape[0]) * m
    stats.replicas_s = root * s.shape[0] + (root - 1) * r.shape[0]

    r_blk, s_blk = _blocks(rng, root, r.shape[0], s.shape[0])
    s_ids = torch.arange(s.shape[0], dtype=torch.int64, device=dev)
    out_i = torch.full((r.shape[0], k), -1, dtype=torch.int64, device=dev)
    s_sel = [torch.as_tensor(np.where(s_blk == j)[0], device=dev)
             for j in range(root)]
    for i in range(root):
        r_sel = torch.as_tensor(np.where(r_blk == i)[0], device=dev)
        if r_sel.numel() == 0:
            continue
        bd, bi = _empty(r_sel.numel(), k, dev)
        for sj in s_sel:
            if sj.numel() == 0:
                continue
            kk = min(k, sj.numel())
            # per-reducer θ from the received S_j subset only (loose, as
            # the paper observes)
            sub_t_s = build_summary(s_part[sj], s_dist[sj], m, k=kk)
            theta = B.compute_theta(pivd, t_r, sub_t_s, kk)
            gd, gi = join_group_pruned(
                r32[r_sel], r_part[r_sel], s32[sj], s_part[sj], s_dist[sj],
                s_ids[sj], pivots, pivd, theta, kk, s_excess=s_excess,
                tile_s=config.tile_s, stats=stats)
            bd, bi = topk_merge(bd, bi, gd ** 2, gi, k)
        out_i[r_sel] = bi
    return _finish(r32, s32, out_i, stats)
