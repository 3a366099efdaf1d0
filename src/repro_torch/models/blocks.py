"""Transformer and recurrent blocks, PyTorch port of the JAX package's
``models.blocks``: one (init, apply) pair per layer kind.

Every block is pre-norm residual. ``ATTN`` (causal), ``ATTN_BIDIR``
(bidirectional) and ``LOCAL`` (sliding window) are norm → attention →
residual → norm → FFN → residual, with the dense FFN or the MoE FFN
(``models.moe``; a ``*_dense`` kind, the leading layers of a MoE stack,
takes a dense FFN of ``first_dense_ff``), and standard attention or MLA.
``XATTN`` (whisper's decoder) adds cross-attention over the encoder's
output between the two; ``RGLRU`` puts Griffin's recurrence in the
attention's place; ``MLSTM`` and ``SLSTM`` are one residual cell each
(``models.recurrent``).

``block_apply`` returns ``(x, cache)``: an attention cache is written in
place and returned, a recurrent state is a new dict. With ``readonly``
(the read-only serving cache's decode) an attention cache is not written
and the attention's fresh pieces come back in its place
(``layers.attn_apply``).

``block_apply_tp`` runs one decoder layer (``ATTN``, or a MoE stack's
leading ``ATTN_dense``) over a model comm (tensor parallelism,
``distributed.tensor_parallel``): each shard's attention (``attn_apply``
or MLA's ``mla_apply`` at its heads) and FFN (the dense MLP at its
columns, or the MoE FFN at its experts and its columns of the shared
and dense MLPs, ``moe_apply(shard=)``) on its own tree and the shards'
view of the config; the two partial outputs (o's, and the FFN's: down's,
or the routed, shared and dense partials summed on the shard, each
rounded to the model's dtype by its product) are summed over the comm in
shard order before each residual add — one psum after the attention, one
after the FFN. Under autograd the sums' backward is the
identity and each norm's output enters the shard's projections through
a psum of their input gradients (``distributed.mesh.psum_fwd`` /
``psum_bwd``); outside it both are the plain psum and nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import (ATTN, ATTN_BIDIR, LOCAL, MLSTM, RGLRU, SLSTM,
                            XATTN, ArchConfig)
from ..distributed.mesh import psum_bwd, psum_fwd
from . import recurrent as R
from .layers import (attn_apply, attn_init, apply_norm, dense, mla_apply,
                     mla_cache, mla_init, mlp_apply, mlp_init, norm_init)
from .moe import moe_apply, moe_init

__all__ = ["block_init", "block_apply", "block_apply_tp",
           "init_block_cache"]

Params = Dict[str, Any]
_ATTN_KINDS = (ATTN, ATTN_BIDIR, LOCAL)


def _base(kind: str) -> str:
    base = kind.replace("_dense", "")
    if base not in _ATTN_KINDS + (XATTN, RGLRU, MLSTM, SLSTM):
        raise ValueError(f"unknown block kind {kind!r}")
    return base


def _ffn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, *,
              dense_ff: int = 0) -> Params:
    """MoE or dense FFN, as the arch says (``dense_ff`` overrides MoE)."""
    if cfg.moe is not None and not dense_ff:
        return {"moe": moe_init(gen, cfg, dtype, device)}
    return {"mlp": mlp_init(gen, cfg, dense_ff or cfg.d_ff, dtype, device)}


def _ffn_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
               shard: int = 0) -> torch.Tensor:
    """The FFN; on a tensor-parallel model shard ``shard``, its partial
    sum."""
    if "moe" in p:
        return moe_apply(p["moe"], x, cfg, shard=shard)
    return mlp_apply(p["mlp"], x, cfg.act)


def block_init(kind: str, gen: torch.Generator, cfg: ArchConfig, dtype,
               device) -> Params:
    base = _base(kind)
    dense_ff = (cfg.moe.first_dense_ff
                if cfg.moe is not None and kind.endswith("_dense") else 0)

    def norm() -> Params:
        return norm_init(cfg.d_model, cfg.norm, dtype, device)

    if base in (MLSTM, SLSTM):
        init = R.mlstm_block_init if base == MLSTM else R.slstm_block_init
        return {"norm1": norm(), "cell": init(gen, cfg, dtype, device)}
    if base == RGLRU:
        p = {"norm1": norm(), "rnn": R.rglru_block_init(gen, cfg, dtype,
                                                         device)}
    elif base == XATTN:
        p = {"norm1": norm(), "attn": attn_init(gen, cfg, dtype, device),
             "normx": norm(), "xattn": attn_init(gen, cfg, dtype, device)}
    else:
        p = {"norm1": norm(),
             "attn": (mla_init(gen, cfg, dtype, device) if cfg.mla is not None
                      else attn_init(gen, cfg, dtype, device))}
    return {**p, "norm2": norm(),
            **_ffn_init(gen, cfg, dtype, device, dense_ff=dense_ff)}


def block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, cache: Optional[Params] = None,
                pos: int = 0, enc_out: Optional[torch.Tensor] = None,
                readonly: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    base = _base(kind)
    h = apply_norm(p["norm1"], x, cfg.norm)
    if base == MLSTM:
        a, cache = R.mlstm_block_apply(p["cell"], h, cfg, state=cache)
        return x + a, cache
    if base == SLSTM:
        a, cache = R.slstm_block_apply(p["cell"], h, cfg, state=cache)
        return x + a, cache
    if base == RGLRU:
        a, cache = R.rglru_block_apply(p["rnn"], h, cfg, state=cache)
    elif base == XATTN:
        a, self_cache = attn_apply(
            p["attn"], h, cfg, positions=positions, causal=True,
            cache=None if cache is None else cache["self"], pos=pos,
            readonly=readonly)
        x = x + a
        hx = apply_norm(p["normx"], x, cfg.norm)
        if enc_out is None and cache is not None:
            # decode without the encoder: reuse the projected encoder kv
            xk, xv = cache["xk"], cache["xv"]
        else:
            b, kvh, dh = x.shape[0], cfg.n_kv_heads, cfg.dh
            xk = dense(p["xattn"]["k"], enc_out).reshape(b, -1, kvh, dh)
            xv = dense(p["xattn"]["v"], enc_out).reshape(b, -1, kvh, dh)
        a, _ = attn_apply(p["xattn"], hx, cfg, positions=positions,
                          xattn_kv=(xk, xv))
        if cache is not None:
            cache = {"self": self_cache, "xk": xk, "xv": xv}
    elif cfg.mla is not None:
        a, cache = mla_apply(p["attn"], h, cfg, positions=positions,
                             cache=cache, pos=pos, readonly=readonly)
    else:
        a, cache = attn_apply(
            p["attn"], h, cfg, positions=positions,
            causal=base != ATTN_BIDIR,
            window=cfg.local_window if base == LOCAL else None, cache=cache,
            pos=pos, readonly=readonly)
    x = x + a
    x = x + _ffn_apply(p, apply_norm(p["norm2"], x, cfg.norm), cfg)
    return x, cache


def block_apply_tp(kind: str, ps: List[Params], xs: List[torch.Tensor],
                   cfg: ArchConfig, comm, *, positions: List[torch.Tensor],
                   caches: Optional[List[Params]] = None, pos: int = 0,
                   readonly: bool = False
                   ) -> Tuple[List[torch.Tensor], List[Optional[Params]]]:
    """One ``ATTN`` (or ``ATTN_dense``) layer over a model comm: ``ps``,
    ``xs``, ``positions`` and ``caches`` hold one entry a shard of
    ``comm.shards``; ``cfg`` is the shards' view
    (``tensor_parallel.shard_config``). Returns the shards' outputs and
    caches (module docstring)."""
    if _base(kind) != ATTN:
        raise ValueError(f"tensor parallelism splits the decoder block, "
                         f"not {kind!r} (ROADMAP A10c)")
    caches = [None] * len(ps) if caches is None else caches
    attend = mla_apply if cfg.mla is not None else attn_apply
    hs = psum_bwd(comm, [apply_norm(p["norm1"], x, cfg.norm)
                         for p, x in zip(ps, xs)])
    outs = [attend(p["attn"], h, cfg, positions=at, cache=c, pos=pos,
                   readonly=readonly)
            for p, h, at, c in zip(ps, hs, positions, caches)]
    a = psum_fwd(comm, [o for o, _ in outs])
    xs = [x + y for x, y in zip(xs, a)]
    hs = psum_bwd(comm, [apply_norm(p["norm2"], x, cfg.norm)
                         for p, x in zip(ps, xs)])
    f = psum_fwd(comm, [_ffn_apply(p, h, cfg, shard=m)
                        for p, h, m in zip(ps, hs, comm.shards)])
    return [x + y for x, y in zip(xs, f)], [c for _, c in outs]


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                     dtype, device) -> Params:
    """Decode-time cache of one layer: ``{"k", "v"}`` of ``(batch,
    cache_len, kv heads, dh)`` zeros (a LOCAL layer's ring holds
    ``min(local_window, cache_len)`` slots); MLA's ``{"ckv": (batch,
    cache_len, kv_lora_rank), "k_rope": (batch, cache_len, rope)}``;
    XATTN's ``{"self": {"k", "v"}, "xk", "xv"}`` (the projected encoder
    kv, ``(batch, enc_len, kv heads, dh)``); a recurrent kind's initial
    state. MLA's two tensors are views of one buffer
    (``layers.mla_cache``)."""
    base = _base(kind)
    if base == RGLRU:
        return R.rglru_init_state(cfg, batch, dtype, device)
    if base == MLSTM:
        return R.mlstm_init_state(cfg, batch, dtype, device)
    if base == SLSTM:
        return R.slstm_init_state(cfg, batch, dtype, device)
    if cfg.mla is not None:
        return mla_cache(batch, cache_len, cfg.mla.kv_lora_rank,
                         cfg.mla.rope_head_dim, dtype, device)

    def kv(n: int) -> Params:
        shape = (batch, n, cfg.n_kv_heads, cfg.dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if base == LOCAL:
        return kv(min(cfg.local_window, cache_len))
    if base == XATTN:
        enc = kv(cfg.enc_len)
        return {"self": kv(cache_len), "xk": enc["k"], "xv": enc["v"]}
    return kv(cache_len)
