"""Backend dispatch for the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written CUDA kernel, whose wrapper launches it or
raises — there is no fallback from the kernel to the plain version.
Each kernel counts its launches (a plain int on its module), which a
run reads to show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import assign as _assign
from . import distance_topk as _gather
from . import flash_attention as _flash
from . import quant_topk as _quant

__all__ = ["assign", "distance_topk", "distance_topk_gather",
           "flash_attention", "quant_coarse_topk", "launch_counts",
           "reset_launch_counts"]


def assign(x: torch.Tensor, pivots: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest pivot per row: (part_id int32, true distance float32)."""
    if x.is_cuda:
        return _assign.assign_cuda(x, pivots)
    return _assign.assign_plain(x, pivots)


def distance_topk(
    r: torch.Tensor, s: torch.Tensor, k: int, *,
    visit_mask: Optional[torch.Tensor] = None, bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``s`` per row of ``r`` over every (R tile, S
    tile) pair ``visit_mask`` (int8, (ceil(n_r/bm), ceil(n_s/bn))) does
    not zero: ascending (√d² float32, int32 row ids), (+inf, -1) for
    empty slots. The kNN-LM brute-force retrieval route."""
    fn = (_gather.distance_topk_cuda if r.is_cuda
          else _gather.distance_topk_plain)
    return fn(r, s, k, visit_mask=visit_mask, bm=bm, bn=bn)


def distance_topk_gather(
    r: torch.Tensor, s: torch.Tensor, k: int, schedule: torch.Tensor,
    counts: torch.Tensor, *, alive: Optional[torch.Tensor] = None,
    bm: int = 128, bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest scheduled rows of ``s`` per row of ``r``: ascending
    (√d² float32, int32 positions), (+inf, -1) for empty slots."""
    fn = (_gather.distance_topk_gather_cuda if r.is_cuda
          else _gather.distance_topk_gather_plain)
    return fn(r, s, k, schedule, counts, alive=alive, bm=bm, bn=bn)


def quant_coarse_topk(
    qi: torch.Tensor, qscale: torch.Tensor, qeps: torch.Tensor,
    theta: torch.Tensor, si: torch.Tensor, sscale: torch.Tensor,
    seps: torch.Tensor, alive: torch.Tensor, mp: int,
    schedule: torch.Tensor, counts: torch.Tensor, *, bm: int = 128,
    bn: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 coarse shortlist of the quantized tier over the scheduled
    tiles: ascending certified lower bounds (float32) and int32 row
    positions, (n, mp); (+inf, -1) for empty slots. Not a result: the
    caller re-ranks and certifies it (``quant.engine``)."""
    fn = (_quant.quant_coarse_gather_cuda if qi.is_cuda
          else _quant.quant_coarse_sched_plain)
    return fn(qi, qscale, qeps, theta, si, sscale, seps, alive, mp,
              schedule, counts, bm=bm, bn=bn)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    scale: Optional[float] = None, softcap: float = 0.0,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over q ``(b, nq, h, d)`` and k, v ``(b, nk, kvh, d)``
    (GQA), queries right-aligned to the keys, causal and/or windowed,
    each scaled logit capped to ``tanh(s / cap) · cap`` when ``softcap``
    > 0; ``k_new``, ``v_new`` (``(b, t, kvh, d)``) are keys read after
    k and v's (the read-only cache's decode). Output ``(b, nq, h, d)`` in
    q's dtype, float32 math inside. The LM's every attention layer,
    prefill, decode and training: where grad is enabled and q, k or v
    requires it, through ``FlashAttentionFn`` (K-F with lse forward, K-B
    backward; their plain versions on the CPU)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if k_new is not None:
            raise ValueError("flash_attention: appended keys are a "
                             "decode-only input (no gradient)")
        return _flash.FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                             softcap)
    fn = (_flash.flash_attention_cuda if q.is_cuda
          else _flash.flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              softcap=softcap, k_new=k_new, v_new=v_new)


def launch_counts() -> Dict[str, int]:
    """Kernel launches in this process since the last reset."""
    return {"assign": _assign.launches,
            "distance_topk": _gather.dense_launches,
            "distance_topk_gather": _gather.launches,
            "flash_attention": _flash.launches,
            "flash_attention_bwd": _flash.bwd_launches,
            "quant_coarse_gather": _quant.launches}


def reset_launch_counts() -> None:
    _assign.launches = 0
    _gather.dense_launches = 0
    _gather.launches = 0
    _flash.launches = 0
    _flash.bwd_launches = 0
    _quant.launches = 0
