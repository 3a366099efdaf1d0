"""Full LM assembly, PyTorch port of the JAX package's ``models.model``:
embedding → the layer stack → final norm → head.

The JAX package scans each ``(unit, reps)`` group of ``cfg.layout()``
over parameters stacked along a leading ``reps`` axis; the port keeps one
parameter dict per layer in ``params["layers"]``, in the stack's order
(:func:`layer_kinds`), and walks them in a Python loop. Only the
``dense`` family runs (all four dense configs: GQA/MQA, SwiGLU or
squared ReLU, RMS or LayerNorm, per-head q/k norm, tied or separate
head); the other families raise ``not_ported``.

A decode cache is ``{"pos": int, "layers": [{"k", "v"}, ...]}``: the
position is a host int, not a device scalar, and each step writes its k
and v into the layer tensors in place.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
fills the cache from position 0 on), ``decode`` (positions continue from
the cache's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..configs.base import ArchConfig
from ..core.index import not_ported
from ..device import resolve_device
from .blocks import block_apply, block_init, init_block_cache
from .layers import apply_norm, norm_init

__all__ = ["ModelOptions", "init_params", "init_cache", "forward",
           "count_params", "layer_kinds"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """The JAX package's ``ModelOptions`` without its training and
    chunking knobs (``remat``, ``chunk_q``: the port has no training step
    and runs attention through K-F at every length) and its learned
    position table (``max_abs_pos``: no dense config has one)."""
    dtype: torch.dtype = torch.bfloat16
    # the JAX serving layout of a mesh (a read-only, length-sharded cache)
    readonly_cache: bool = False


def _check_arch(cfg: ArchConfig, opts: ModelOptions) -> None:
    if cfg.family != "dense":
        raise not_ported(f"the {cfg.family!r} family ({cfg.name})", "A6")
    if cfg.attn_logit_softcap > 0:
        raise not_ported("attention with a logit softcap (K-F has none, as "
                         "the TPU kernel)", "A6")
    if opts.readonly_cache:
        raise not_ported("the read-only serving cache (a mesh layout)", "A6")


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
    _check_arch(cfg, opts)
    dev = resolve_device(device)
    dtype = opts.dtype

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(dtype)

    params: Params = {
        "embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5)
    params["layers"] = [block_init(kind, gen, cfg, dtype, dev)
                        for kind in layer_kinds(cfg)]
    return params


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               opts: ModelOptions = ModelOptions(), *,
               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """An empty decode cache at position 0."""
    _check_arch(cfg, opts)
    dev = resolve_device(device)
    return {"pos": 0,
            "layers": [init_block_cache(kind, cfg, batch, cache_len,
                                        opts.dtype, dev)
                       for kind in layer_kinds(cfg)]}


def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                      # (B, T) integer
    *,
    positions: Optional[torch.Tensor] = None,  # (B, T); default iota
    cache: Optional[Dict[str, Any]] = None,
    opts: ModelOptions = ModelOptions(),
    mode: str = "train",
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns ``(logits (B, T, V) float32, cache)``; with a cache, its
    position advances by T."""
    _check_arch(cfg, opts)
    b, t = tokens.shape
    dev = params["embed"].device
    pos = 0 if cache is None else int(cache["pos"])
    if positions is None:
        base = torch.arange(t, dtype=torch.int32, device=dev)[None]
        if cache is not None and mode == "decode":
            base = base + pos
        positions = base.expand(b, t)
    x = params["embed"][tokens.to(device=dev, dtype=torch.int64)] \
        .to(opts.dtype)
    kinds = layer_kinds(cfg)
    for i, (kind, lp) in enumerate(zip(kinds, params["layers"])):
        x, _ = block_apply(kind, lp, x, cfg, positions=positions,
                           cache=None if cache is None
                           else cache["layers"][i], pos=pos)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head).to(torch.float32)
    if cache is not None:
        cache["pos"] = pos + t
    return logits, cache


def count_params(params) -> int:
    """Parameters in a tree of dicts and lists of tensors."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0
