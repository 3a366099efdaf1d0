"""Sorted-run merges outside the kernels — PyTorch port of the JAX
package's ``kernels.sorted_merge`` jnp siblings.

In the JAX package ``tile_topk`` / ``merge_sorted_runs`` (bitonic
networks) are the in-kernel body of the Pallas top-k kernels; in the
port that body is the device code of the gather kernel
(``csrc/sorted_run.cuh``: a per-lane insertion run and a warp merge).
What runs outside a kernel is the id-dedup merge of two ascending runs
(the megastep's carried-state merge and ``StreamJoinState.update``),
written here as plain torch ops. Ids are native int64.
"""
from __future__ import annotations

import torch

__all__ = ["next_pow2", "mask_duplicate_ids", "merge_sorted_runs_unique"]


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
