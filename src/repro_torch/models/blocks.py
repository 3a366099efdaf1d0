"""Transformer blocks, PyTorch port of the JAX package's ``models.blocks``
— the attention kinds.

Every block is pre-norm residual: norm → attention → residual → norm →
FFN → residual. ``ATTN`` (causal), ``ATTN_BIDIR`` (bidirectional) and
``LOCAL`` (sliding window) run here; the recurrent, xLSTM and
cross-attention kinds and the MoE FFN are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ATTN, ATTN_BIDIR, LOCAL, ArchConfig
from ..core.index import not_ported
from .layers import (attn_apply, attn_init, apply_norm, mlp_apply, mlp_init,
                     norm_init)

__all__ = ["block_init", "block_apply", "init_block_cache"]

Params = Dict[str, Any]
_ATTN_KINDS = (ATTN, ATTN_BIDIR, LOCAL)


def _check_kind(kind: str, cfg: ArchConfig) -> None:
    if kind not in _ATTN_KINDS:
        raise not_ported(f"the {kind!r} block", "A6")
    if cfg.moe is not None:
        raise not_ported("the MoE FFN", "A6")
    if cfg.mla is not None:
        raise not_ported("multi-head latent attention (MLA)", "A6")


def block_init(kind: str, gen: torch.Generator, cfg: ArchConfig, dtype,
               device) -> Params:
    _check_kind(kind, cfg)
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "norm2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(gen, cfg, cfg.d_ff, dtype, device),
    }


def block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, cache: Optional[Params] = None,
                pos: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    _check_kind(kind, cfg)
    a, cache = attn_apply(
        p["attn"], apply_norm(p["norm1"], x, cfg.norm), cfg,
        positions=positions, causal=kind != ATTN_BIDIR,
        window=cfg.local_window if kind == LOCAL else None, cache=cache,
        pos=pos)
    x = x + a
    x = x + mlp_apply(p["mlp"], apply_norm(p["norm2"], x, cfg.norm), cfg.act)
    return x, cache


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                     dtype, device) -> Params:
    """Decode-time cache of one layer: ``{"k", "v"}`` of ``(batch,
    cache_len, kv heads, dh)`` zeros."""
    _check_kind(kind, cfg)
    if kind == LOCAL:
        raise not_ported("the ring-buffer decode cache of local attention",
                         "A6")
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
