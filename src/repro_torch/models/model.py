"""Full LM assembly, PyTorch port of the JAX package's ``models.model``:
embedding → the layer stack → final norm → head, and whisper's encoder.

The JAX package scans each ``(unit, reps)`` group of ``cfg.layout()``
over parameters stacked along a leading ``reps`` axis; the port keeps one
parameter dict per layer in ``params["layers"]`` (and per encoder layer
in ``params["encoder"]``), in the stack's order (:func:`layer_kinds`),
and walks them in a Python loop. Every family runs: ``dense``, ``moe``
(MLA and the MoE FFN), ``hybrid`` (recurrentgemma: RG-LRU and local
attention over a ring cache), ``ssm`` (xLSTM), ``audio`` (whisper: a
bidirectional encoder over stub frame embeddings, a decoder with
cross-attention and learned positions) and ``vlm`` (qwen2-vl: M-RoPE
over (3, B, T) positions, stub vision embeddings over the first
positions). A config's ``attn_logit_softcap`` caps the attention logits
inside K-F and K-B (``layers``).

A decode cache is ``{"pos": int, "layers": [one per layer]}``: the
position is a host int, not a device scalar; an attention layer's
tensors are written in place, a recurrent layer's state is replaced.
With ``ModelOptions.readonly_cache`` (the JAX package's serving layout)
a decode step writes nothing into the cache it is given: it returns a
new ``{"pos": pos + 1, "layers": [...]}`` whose attention layers hold
the step's fresh pieces (``{"k_new", "v_new", "pos"}``; MLA
``{"ckv_new", "k_rope_new", "pos"}``; whisper's ``{"self": ..., "xk",
"xv"}``) and whose ring and recurrent layers hold their new state, and
:func:`append_readonly` writes those pieces into the cache out of band.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
fills the cache from position 0 on), ``decode`` (positions continue from
the cache's). In ``train`` mode with ``ModelOptions.remat`` and grad
enabled, each layer runs under ``torch.utils.checkpoint`` (non-reentrant;
the counterpart of the JAX package's ``jax.checkpoint`` of its scan body):
its activations are recomputed in the backward pass, so K-F runs twice
per layer a training step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ATTN_BIDIR, ArchConfig
from ..device import resolve_device
from .blocks import block_apply, block_init, init_block_cache
from .layers import apply_norm, norm_init, normal_init

__all__ = ["ModelOptions", "init_params", "init_cache", "encode", "forward",
           "append_readonly", "count_params", "layer_kinds"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """The JAX package's ``ModelOptions`` without its chunking knob
    (``chunk_q``: the port runs attention through K-F, forward and
    backward, at every length). ``remat`` recomputes each layer's
    activations in the backward pass (``train`` mode only)."""
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    max_abs_pos: int = 4096  # learned position table (rope == "none")
    # the JAX serving layout: decode treats the cache as a read-only input
    # and returns the step's fresh pieces for an out-of-band append
    readonly_cache: bool = False


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The block kind of every layer, in the order of the stack."""
    return [kind for unit, reps in cfg.layout() for _ in range(reps)
            for kind in unit]


def init_params(cfg: ArchConfig, gen: torch.Generator,
                opts: ModelOptions = ModelOptions(), *,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
    ``device``) in ``opts.dtype``, with the JAX package's shapes and
    scales (its draws differ: ``models.convert`` carries JAX parameters
    across)."""
    dev = resolve_device(device)
    dtype = opts.dtype

    params: Params = {
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype,
                             dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if cfg.rope == "none" and cfg.abs_pos:
        params["pos_embed"] = normal_init(gen, (opts.max_abs_pos,
                                                cfg.d_model), 0.02, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab),
                                        cfg.d_model ** -0.5, dtype, dev)
    params["layers"] = [block_init(kind, gen, cfg, dtype, dev)
                        for kind in layer_kinds(cfg)]
    if cfg.n_enc_layers:
        params["encoder"] = [block_init(ATTN_BIDIR, gen, cfg, dtype, dev)
                             for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, dev)
        params["enc_pos_embed"] = normal_init(
            gen, (cfg.enc_len, cfg.d_model), 0.02, dtype, dev)
    return params


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               opts: ModelOptions = ModelOptions(), *,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """An empty decode cache at position 0."""
    dev = resolve_device(device)
    return {"pos": 0,
            "layers": [init_block_cache(kind, cfg, batch, cache_len,
                                        opts.dtype, dev)
                       for kind in layer_kinds(cfg)]}


def encode(params: Params, cfg: ArchConfig, enc_frames: torch.Tensor,
           opts: ModelOptions = ModelOptions()) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, enc_len, D):
    learned positions, the bidirectional layers, the encoder norm."""
    dev = params["embed"].device
    x = enc_frames.to(device=dev, dtype=opts.dtype) \
        + params["enc_pos_embed"][None]
    b = x.shape[0]
    positions = torch.arange(cfg.enc_len, dtype=torch.int32,
                             device=dev)[None].expand(b, cfg.enc_len)
    remat = opts.remat and torch.is_grad_enabled()
    for lp in params["encoder"]:
        x, _ = _apply(remat, ATTN_BIDIR, lp, x, cfg, positions=positions)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                      # (B, T) integer
    *,
    positions: Optional[torch.Tensor] = None,  # (B, T) or (3, B, T); iota
    cache: Optional[Dict[str, Any]] = None,
    enc_frames: Optional[torch.Tensor] = None,
    enc_out: Optional[torch.Tensor] = None,
    vision_embeds: Optional[torch.Tensor] = None,
    opts: ModelOptions = ModelOptions(),
    mode: str = "train",
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns ``(logits (B, T, V) float32, cache)``; with a cache, its
    position advances by T. An encoder-decoder arch needs ``enc_out``
    (:func:`encode`'s output) or ``enc_frames`` (encoded here);
    ``vision_embeds`` (B, n_vision_embeds, D) replace the first
    positions' embeddings outside decode. With
    ``opts.readonly_cache`` a decode step leaves ``cache`` untouched and
    returns a new one (module docstring)."""
    b, t = tokens.shape
    dev = params["embed"].device
    pos = 0 if cache is None else int(cache["pos"])
    if positions is None:
        base = torch.arange(t, dtype=torch.int32, device=dev)[None]
        if cache is not None and mode == "decode":
            base = base + pos
        positions = base.expand(b, t)
        if cfg.rope == "mrope":
            positions = positions[None].expand(3, b, t)
    x = params["embed"][tokens.to(device=dev, dtype=torch.int64)] \
        .to(opts.dtype)
    if cfg.rope == "none" and cfg.abs_pos:
        pos2 = positions if positions.dim() == 2 else positions[0]
        x = x + params["pos_embed"][pos2.to(torch.int64)].to(opts.dtype)
    if (vision_embeds is not None and cfg.n_vision_embeds
            and mode != "decode"):
        nv = cfg.n_vision_embeds
        x = torch.cat([vision_embeds.to(device=dev, dtype=opts.dtype),
                       x[:, nv:]], dim=1)
    if cfg.n_enc_layers and enc_out is None:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder arch: pass "
                             f"enc_frames or enc_out")
        enc_out = encode(params, cfg, enc_frames, opts)
    kinds = layer_kinds(cfg)
    remat = opts.remat and mode == "train" and torch.is_grad_enabled()
    readonly = opts.readonly_cache and mode == "decode" and cache is not None
    out_cache = {"pos": pos, "layers": [None] * len(kinds)} if readonly \
        else cache
    for i, (kind, lp) in enumerate(zip(kinds, params["layers"])):
        x, new = _apply(remat, kind, lp, x, cfg, positions=positions,
                        cache=None if cache is None else cache["layers"][i],
                        pos=pos, enc_out=enc_out, readonly=readonly)
        if out_cache is not None:
            out_cache["layers"][i] = new
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head).to(torch.float32)
    if out_cache is not None:
        out_cache["pos"] = pos + t
    return logits, out_cache


def append_readonly(cache: Dict[str, Any], fresh: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """Write a read-only decode step's fresh pieces (``fresh``, what
    :func:`forward` returned) into ``cache`` at its position, in place —
    the out-of-band append of the JAX package's serving layout — and
    advance its position; ring and recurrent layers take their new
    state. Returns ``cache``."""
    pos = int(cache["pos"])

    def write(layer, new):
        if "k_new" in new:
            t = new["k_new"].shape[1]
            layer["k"][:, pos:pos + t] = new["k_new"]
            layer["v"][:, pos:pos + t] = new["v_new"]
            return layer
        if "ckv_new" in new:
            t = new["ckv_new"].shape[1]
            layer["ckv"][:, pos:pos + t] = new["ckv_new"]
            layer["k_rope"][:, pos:pos + t] = new["k_rope_new"]
            return layer
        if "self" in new:
            return dict(layer, self=write(layer["self"], new["self"]))
        return new

    cache["layers"] = [write(layer, new) for layer, new
                       in zip(cache["layers"], fresh["layers"])]
    cache["pos"] = fresh["pos"]
    return cache


def _apply(remat: bool, kind: str, lp: Params, x: torch.Tensor,
           cfg: ArchConfig, **kw):
    """``block_apply``, under ``torch.utils.checkpoint`` with ``remat``."""
    if not remat:
        return block_apply(kind, lp, x, cfg, **kw)
    return checkpoint(block_apply, kind, lp, x, cfg, use_reentrant=False,
                      **kw)


def count_params(params) -> int:
    """Parameters in a tree of dicts and lists of tensors."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0
