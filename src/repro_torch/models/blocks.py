"""Transformer blocks, PyTorch port of the JAX package's ``models.blocks``
— the attention kinds.

Every block is pre-norm residual: norm → attention → residual → norm →
FFN → residual. ``ATTN`` (causal), ``ATTN_BIDIR`` (bidirectional) and
``LOCAL`` (sliding window) run here, with the dense FFN or the MoE FFN
(``models.moe``; a ``*_dense`` kind, the leading layers of a MoE stack,
takes a dense FFN of ``first_dense_ff``), and standard attention or MLA.
The recurrent, xLSTM and cross-attention kinds are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ATTN, ATTN_BIDIR, LOCAL, ArchConfig
from ..core.index import not_ported
from .layers import (attn_apply, attn_init, apply_norm, mla_apply, mla_init,
                     mlp_apply, mlp_init, norm_init)
from .moe import moe_apply, moe_init

__all__ = ["block_init", "block_apply", "init_block_cache"]

Params = Dict[str, Any]
_ATTN_KINDS = (ATTN, ATTN_BIDIR, LOCAL)


def _base(kind: str) -> str:
    base = kind.replace("_dense", "")
    if base not in _ATTN_KINDS:
        raise not_ported(f"the {kind!r} block", "A6")
    return base


def _ffn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, *,
              dense_ff: int = 0) -> Params:
    """MoE or dense FFN, as the arch says (``dense_ff`` overrides MoE)."""
    if cfg.moe is not None and not dense_ff:
        return {"moe": moe_init(gen, cfg, dtype, device)}
    return {"mlp": mlp_init(gen, cfg, dense_ff or cfg.d_ff, dtype, device)}


def _ffn_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if "moe" in p:
        return moe_apply(p["moe"], x, cfg)
    return mlp_apply(p["mlp"], x, cfg.act)


def block_init(kind: str, gen: torch.Generator, cfg: ArchConfig, dtype,
               device) -> Params:
    _base(kind)
    dense_ff = (cfg.moe.first_dense_ff
                if cfg.moe is not None and kind.endswith("_dense") else 0)
    attn = (mla_init(gen, cfg, dtype, device) if cfg.mla is not None
            else attn_init(gen, cfg, dtype, device))
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn,
        "norm2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        **_ffn_init(gen, cfg, dtype, device, dense_ff=dense_ff),
    }


def block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, cache: Optional[Params] = None,
                pos: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    base = _base(kind)
    h = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.mla is not None:
        a, cache = mla_apply(p["attn"], h, cfg, positions=positions,
                             cache=cache, pos=pos)
    else:
        a, cache = attn_apply(
            p["attn"], h, cfg, positions=positions,
            causal=base != ATTN_BIDIR,
            window=cfg.local_window if base == LOCAL else None, cache=cache,
            pos=pos)
    x = x + a
    x = x + _ffn_apply(p, apply_norm(p["norm2"], x, cfg.norm), cfg)
    return x, cache


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                     dtype, device) -> Params:
    """Decode-time cache of one layer: ``{"k", "v"}`` of ``(batch,
    cache_len, kv heads, dh)`` zeros, or MLA's ``{"ckv": (batch,
    cache_len, kv_lora_rank), "k_rope": (batch, cache_len, rope)}``."""
    if _base(kind) == LOCAL:
        raise not_ported("the ring-buffer decode cache of local attention",
                         "A6")
    if cfg.mla is not None:
        c = cfg.mla
        return {"ckv": torch.zeros((batch, cache_len, c.kv_lora_rank),
                                   dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, cache_len, c.rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
