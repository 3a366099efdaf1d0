"""Brute-force oracle (paper §3, §6) — PyTorch port of the JAX package's
``core.baselines.brute_force_knn``. The paper's competitor baselines
H-BRJ and PBJ, and the L1/L∞ oracle, are the rest of ROADMAP Queue A1
and raise until ported."""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .index import not_ported
from .metrics import canonical_topk

__all__ = ["brute_force_knn", "hbrj_join", "pbj_join"]


def brute_force_knn(
    r: np.ndarray, s: np.ndarray, k: int, *, tile_r: int = 256,
    metric: str = "l2", device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact oracle: (dists float32, ids int64), ascending. O(|R||S|).

    Selection runs in float64 (an oracle must out-resolve the engines'
    float32 noise — on data far from the origin real kNN gaps can sit
    below f32 cancellation error); reported distances then go through
    the same canonical float32 chain (`metrics.canonical_topk`) the
    engines emit, so oracle and engine outputs compare directly.
    """
    if metric != "l2":
        raise not_ported(f"brute_force_knn(metric={metric!r})", "A1")
    dev = resolve_device(device)
    r32 = torch.as_tensor(np.asarray(r, np.float32), device=dev)
    s32 = torch.as_tensor(np.asarray(s, np.float32), device=dev)
    s64 = s32.to(torch.float64)
    s2 = (s64 * s64).sum(-1)
    out_i = torch.empty((r32.shape[0], k), dtype=torch.int64, device=dev)
    for lo in range(0, r32.shape[0], tile_r):
        q = r32[lo:lo + tile_r].to(torch.float64)
        d = (q * q).sum(-1)[:, None] + s2[None, :] - 2.0 * (q @ s64.T)
        dk, part = torch.topk(d, k, dim=1, largest=False)
        order = torch.argsort(dk, dim=1, stable=True)
        out_i[lo:lo + tile_r] = torch.take_along_dim(part, order, dim=1)
    neigh = s32[out_i.clamp(0, s32.shape[0] - 1)]
    out_d, out_i = canonical_topk(r32, out_i, neigh, metric)
    return out_d.cpu().numpy(), out_i.cpu().numpy()


def hbrj_join(*args, **kwargs):
    """H-BRJ (Zhang et al., EDBT'12), the paper's §6 competitor."""
    raise not_ported("hbrj_join (the paper's H-BRJ baseline)", "A1")


def pbj_join(*args, **kwargs):
    """PBJ: PGBJ's bounds without grouping, the paper's §6 competitor."""
    raise not_ported("pbj_join (the paper's PBJ baseline)", "A1")
