"""Primitive layers of the LM substrate, PyTorch port of the JAX package's
``models.layers`` — the dense subset.

Parameters are nested dicts of tensors in the JAX package's layout: a
``dense`` weight is ``(d_in, d_out)`` and applies as ``x @ w`` (so
``models.convert`` carries JAX weights across unchanged). Initializers
take an explicit ``torch.Generator``, a dtype and a device; they draw
other numbers than ``jax.random`` from the same seed.

Self-attention runs through the flash attention kernel K-F
(``kernels.ops.flash_attention``): over the whole sequence in training
and prefill without a cache, and with a decode cache over its live part
``k[:, :pos + t]`` with the queries right-aligned, which is the function
the JAX ``_sdpa`` computes over the whole cache masked causally at offset
``pos``. The model's matrix products stay ``torch.matmul``. The
ring-buffer cache of local attention, the read-only serving cache, MLA,
M-RoPE, cross-attention and a logit softcap are not ported
(``not_ported``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.index import not_ported
from ..kernels import ops

__all__ = ["dense_init", "dense", "norm_init", "apply_norm", "rope_freqs",
           "apply_rope", "mlp_init", "mlp_apply", "repeat_kv", "attn_init",
           "attn_apply"]

Params = Dict[str, Any]


# ----------------------------------------------------------------- utils
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               *, scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    return {"w": w.to(dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"])


def norm_init(d: int, kind: str, dtype, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """Statistics in float32, elementwise math in the input dtype."""
    x32 = x.to(torch.float32)
    if kind == "rms":
        var = torch.mean(torch.square(x32), -1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * p["scale"]
    mu32 = torch.mean(x32, -1, keepdim=True)
    var = torch.mean(torch.square(x32), -1, keepdim=True) - torch.square(mu32)
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps).to(x.dtype)
    return (x - mu32.to(x.dtype)) * inv * p["scale"] + p["bias"]


# ------------------------------------------------------------------ RoPE
def rope_freqs(dh_half: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(dh_half, dtype=torch.float32, device=device) / dh_half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, T, H, dh), positions (B, T) → rotated x (split halves, the
    rotation in float32)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh // 2, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs     # (B, T, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP
def mlp_init(gen: torch.Generator, cfg: ArchConfig, d_ff: int, dtype,
             device) -> Params:
    d = cfg.d_model
    p = {"down": dense_init(gen, d_ff, d, dtype, device)}
    if cfg.act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d, d_ff, dtype, device)
        p["up"] = dense_init(gen, d, d_ff, dtype, device)
    else:
        p["up"] = dense_init(gen, d, d_ff, dtype, device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    if act == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    elif act == "geglu":
        h = F.gelu(dense(p["gate"], x), approximate="tanh") * dense(p["up"], x)
    elif act == "relu2":
        h = torch.square(F.relu(dense(p["up"], x)))
    elif act == "gelu":
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    else:
        raise ValueError(act)
    return dense(p["down"], h)


def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    if rep == 1:
        return x
    return torch.repeat_interleave(x, rep, dim=2)


# ------------------------------------------------------------ attention
def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    d, dh = cfg.d_model, cfg.dh
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    p = {
        "q": dense_init(gen, d, h * dh, dtype, device),
        "k": dense_init(gen, d, kvh * dh, dtype, device),
        "v": dense_init(gen, d, kvh * dh, dtype, device),
        "o": dense_init(gen, h * dh, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(dh, "rms", dtype, device)
        p["k_norm"] = norm_init(dh, "rms", dtype, device)
    return p


def attn_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,           # (B, T)
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[Params] = None,    # {"k", "v"} decode cache of this layer
    pos: int = 0,                      # the cache's position (host int)
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention, writing this step's k and v into ``cache`` at
    ``pos`` in place (the JAX package returns an updated copy); returns
    ``(out, cache)``."""
    if cfg.attn_logit_softcap > 0:
        raise not_ported("attention with a logit softcap (K-F has none, as "
                         "the TPU kernel)", "A6")
    if cfg.rope == "mrope":
        raise not_ported("M-RoPE (the VLM family)", "A6")
    b, t, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = dense(p["q"], x).reshape(b, t, h, dh)
    k = dense(p["k"], x).reshape(b, t, kvh, dh)
    v = dense(p["v"], x).reshape(b, t, kvh, dh)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rms")
        k = apply_norm(p["k_norm"], k, "rms")
    if cfg.rope == "std":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        if window is not None:
            raise not_ported("the ring-buffer decode cache of local "
                             "attention", "A6")
        if not causal:
            raise not_ported("bidirectional attention over a decode cache",
                             "A6")
        cache["k"][:, pos:pos + t] = k
        cache["v"][:, pos:pos + t] = v
        k, v = cache["k"][:, :pos + t], cache["v"][:, :pos + t]
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              scale=dh ** -0.5)
    return dense(p["o"], out.reshape(b, t, h * dh)), cache
