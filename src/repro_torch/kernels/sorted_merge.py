"""Sorted-run merges outside the kernels — PyTorch port of the JAX
package's ``kernels.sorted_merge`` jnp siblings.

In the JAX package ``tile_topk`` / ``merge_sorted_runs`` (bitonic
networks) are the in-kernel body of the Pallas top-k kernels; in the
port that body is the device code of the gather kernel
(``csrc/sorted_run.cuh``: a per-lane insertion run and a warp merge).
What runs outside a kernel is the merge of ascending runs — the
id-dedup merge of two runs (the megastep's carried-state merge and
``StreamJoinState.update``) and the id-disjoint tree merge of the
sharded megastep's per-shard runs (``core.sharded``) — written here as
plain torch ops. Ids are native int64.
"""
from __future__ import annotations

import torch

__all__ = ["next_pow2", "mask_duplicate_ids", "merge_sorted_runs",
           "merge_sorted_runs_unique", "tree_merge_runs"]


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def mask_duplicate_ids(ad: torch.Tensor, ai: torch.Tensor,
                       bd: torch.Tensor, bi: torch.Tensor):
    """Suppress B-run entries whose id already appears in the A run.

    An id in both runs references the same row, so both copies carry
    the same canonical distance; A absorbs the elementwise min of its
    duplicates' distances anyway, and B's copy is demoted to (+inf, -1)
    so the merge never returns a row twice. Padding lanes (id -1, +inf)
    are "duplicates" of each other by this rule, which is a no-op.
    O(k²) compares.
    """
    eq = ai[..., :, None] == bi[..., None, :]        # (..., ka, kb)
    inf = float("inf")
    ad = torch.minimum(ad, torch.where(eq, bd[..., None, :], inf).amin(-1))
    b_dup = eq.any(dim=-2)
    bd = torch.where(b_dup, inf, bd)
    bi = torch.where(b_dup, -1, bi)
    return ad, ai, bd, bi


def merge_sorted_runs_unique(ad: torch.Tensor, ai: torch.Tensor,
                             bd: torch.Tensor, bi: torch.Tensor):
    """Top-kp merge of two ascending kp-runs with id dedup: a row present
    in both runs contributes one entry, at its smaller distance. Dedup
    punches +inf holes into the runs, so the order is re-established by
    one stable sort of the concatenation (ties keep A before B). Returns
    the kp smallest as ``(d, ids)``."""
    ad, ai, bd, bi = mask_duplicate_ids(ad, ai, bd, bi)
    kp = ad.shape[-1]
    if bd.shape[-1] != kp:
        raise ValueError(f"runs differ in width: {kp} vs {bd.shape[-1]}")
    d = torch.cat([ad, bd], dim=-1)
    i = torch.cat([ai, bi], dim=-1)
    d, order = torch.sort(d, dim=-1, stable=True)
    return d[..., :kp], torch.take_along_dim(i, order, dim=-1)[..., :kp]


def merge_sorted_runs(ad: torch.Tensor, ai: torch.Tensor,
                      bd: torch.Tensor, bi: torch.Tensor, *extra):
    """Top-kp merge of two ascending kp-runs whose ids are disjoint
    (padding (+inf, -1) aside): the kp smallest of the union in (d, id)
    order. Ties resolve by id, never by which run an entry came from, so
    the merge is commutative and a fold of many runs does not depend on
    their order. ``extra`` holds more columns of the two runs, as pairs
    (a's, b's), carried along. Returns ``(d, ids, *extra)``."""
    kp = ad.shape[-1]
    if bd.shape[-1] != kp:
        raise ValueError(f"runs differ in width: {kp} vs {bd.shape[-1]}")
    cols = [torch.cat([ai, bi], dim=-1)] + [
        torch.cat([x, y], dim=-1) for x, y in extra]
    d = torch.cat([ad, bd], dim=-1)
    by_id = torch.argsort(cols[0], dim=-1, stable=True)
    d = torch.take_along_dim(d, by_id, dim=-1)
    d, order = torch.sort(d, dim=-1, stable=True)
    order = torch.take_along_dim(by_id, order, dim=-1)[..., :kp]
    return (d[..., :kp], *(torch.take_along_dim(c, order, dim=-1)
                           for c in cols))


def tree_merge_runs(runs, *, unique: bool = False):
    """Fold N ascending ``(d, ids)`` runs into one through a balanced
    pairwise merge tree — ceil(log2 N) rounds of :func:`merge_sorted_runs`
    (``unique=True``: :func:`merge_sorted_runs_unique`, for runs that may
    share ids). All runs share one width and one device; a run may carry
    more columns after its ids, ``(d, ids, *extra)``, kept in step
    (``unique`` runs carry none).

    The sharded megastep's reduction: rows live on exactly one shard, so
    the shards' runs are id-disjoint and the fold is the top-kp of their
    union in (d, id) order — for any order of the runs and any subset of
    them too (the degraded-coverage path merges the surviving shards)."""
    if not runs:
        raise ValueError("tree_merge_runs needs at least one run")
    widths = {int(run[0].shape[-1]) for run in runs}
    if len(widths) != 1:
        raise ValueError(
            f"tree_merge_runs needs equal-width runs, got widths "
            f"{sorted(widths)} — pad every run to one width first")

    def fold(a, b):
        if unique:
            return merge_sorted_runs_unique(*a, *b)
        return merge_sorted_runs(a[0], a[1], b[0], b[1],
                                 *zip(a[2:], b[2:]))

    runs = [tuple(run) for run in runs]
    while len(runs) > 1:
        nxt = [fold(runs[a], runs[a + 1])
               for a in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]
