"""Primitive layers of the LM substrate, PyTorch port of the JAX package's
``models.layers``.

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
``pos``. In training its gradient is K-F's backward kernel K-B
(``ops.flash_attention`` routes inputs that require grad through
``FlashAttentionFn``). The model's matrix products stay ``torch.matmul``.

Multi-head latent attention (MLA, DeepSeek-V2) runs on K-F in both of
the JAX package's forms: *expanded* without a cache (per-head keys and
values out of the latent; v zero-padded to the q·k width, which K-F
needs, and the output cut back), *absorbed* with one (every call with
a cache, prefill included, as the JAX ``absorb=True`` default: MQA over
the compressed cache, q' = [q_nope·W_uk, q_rope] against k' = [ckv,
k_rope], v = k' itself and the first ``kv_lora_rank`` output columns
kept, which is probs·ckv). Both take the JAX scale (qk_nope +
rope)^−0.5.

Local attention decodes over a ring-buffer cache (:func:`attn_apply`),
cross-attention (whisper's decoder) runs K-F non-causal over the
projected encoder output, and M-RoPE (qwen2-vl) rotates sections of the
head by three position axes. ``cfg.attn_logit_softcap`` > 0 caps every
standard attention's logits inside K-F (and K-B), as the JAX ``_sdpa``,
ring and read-only decode do; MLA never takes the cap (the JAX package
passes ``softcap=0.0`` there).

The read-only serving cache (``readonly=True``, decode only): the
layer's cache is an input that is never written; its keys before
``pos`` and the step's fresh key are one softmax, K-F reading the cache
in place and the fresh k / v as a second key source. The layer returns
the fresh pieces for an out-of-band append (``{"k_new", "v_new",
"pos"}``; MLA ``{"ckv_new", "k_rope_new", "pos"}``), keyed as in the JAX
package. A local layer's ring cache ignores it, as there (its ring is
copied before the step's write, so the input stays untouched). MLA's
cache (:func:`mla_cache`) keeps ``ckv`` and ``k_rope`` as two views of
one ``(b, n, kv_lora + rope)`` buffer, so the absorbed form's keys
``[ckv, k_rope]`` are that buffer, read in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops

__all__ = ["dense_init", "dense", "normal_init", "norm_init", "apply_norm",
           "rope_freqs", "rope_tables", "apply_rope", "apply_mrope",
           "mlp_init", "mlp_apply", "repeat_kv", "attn_init", "attn_apply",
           "mla_init", "mla_apply", "mla_cache", "latent_keys"]

Params = Dict[str, Any]


# ----------------------------------------------------------------- utils
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               *, scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    return {"w": w.to(dtype)}


# elements a float32 draw holds at once before its cast (1 GiB): the
# largest leaves (Arctic's experts: 17.8 GB in float32) are drawn in
# slices along their first axis
_DRAW_ELEMS = 1 << 28


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """``randn(shape) · scale`` drawn in float32 from ``gen`` and cast to
    ``dtype``, at most ``_DRAW_ELEMS`` float32 values at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    per = max(1, _DRAW_ELEMS // max(1, out[0].numel())) if out.dim() else 1
    if out.dim() == 0 or per >= shape[0]:
        out.copy_(torch.randn(shape, generator=gen, dtype=torch.float32,
                              device=device) * scale)
        return out
    for lo in range(0, shape[0], per):
        hi = min(lo + per, shape[0])
        out[lo:hi] = torch.randn((hi - lo,) + tuple(shape[1:]),
                                 generator=gen, dtype=torch.float32,
                                 device=device) * scale
    return out


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
# The JAX package builds these tables in float32 with its own pow, cos and
# sin. Vectorized float32 versions of those ops differ by an ulp or more
# between CPUs (by ISA) and between the CPU and the card, and at a few
# hundred positions one ulp of an angle moves a logit by ~1e-5. So the
# port computes the frequencies and the cos / sin in float64 and rounds
# each once to float32 (the same float32 on every device, but where the
# two devices' float64 values straddle a float32 rounding boundary, about
# one value in 10^8); the angle stays JAX's float32 product position ×
# freq, one IEEE multiply, the same bits everywhere.
def rope_freqs(dh_half: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(dh_half, dtype=torch.float64, device=device) / dh_half
    return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64,
                                         device=device), e)
            ).to(torch.float32)


def _cos_sin(angles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of float32 angles, taken in float64, rounded once."""
    a64 = angles.to(torch.float64)
    return torch.cos(a64).to(torch.float32), torch.sin(a64).to(torch.float32)


def rope_tables(positions: torch.Tensor, dh_half: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the float32 angles position × freq, each taken in
    float64 and rounded once to float32: shape ``positions.shape +
    (dh_half,)``."""
    freqs = rope_freqs(dh_half, theta, device=positions.device)
    return _cos_sin(positions[..., None].to(torch.float32) * freqs)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, dh) rotated by (B, T, dh/2) tables (split halves, the
    rotation in float32)."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, T, H, dh), positions (B, T) → rotated x."""
    return _rotate(x, *rope_tables(positions, x.shape[-1] // 2, theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): positions (3, B, T) — the temporal, height and
    width ids — drive consecutive ``sections`` of the half-dim's
    frequencies; the tables as :func:`rope_tables`'."""
    dh_half = x.shape[-1] // 2
    if sum(sections) != dh_half:
        raise ValueError(f"M-RoPE sections {sections} do not cover half "
                         f"the head width {dh_half}")
    freqs = rope_freqs(dh_half, theta, device=x.device)
    # each frequency slot's position: its section's axis (t, h or w)
    pos = torch.cat([positions[i, ..., None].to(torch.float32).expand(
        -1, -1, n) for i, n in enumerate(sections)], dim=-1)  # (B, T, dh/2)
    return _rotate(x, *_cos_sin(pos * freqs))


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
    positions: torch.Tensor,           # (B, T), or (3, B, T) for M-RoPE
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[Params] = None,    # {"k", "v"} decode cache of this layer
    pos: int = 0,                      # the cache's position (host int)
    xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    readonly: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention, writing this step's k and v into ``cache`` in
    place (the JAX package returns an updated copy), or cross-attention
    over precomputed ``xattn_kv`` (B, C, kvh, dh): no rope, no q/k norm,
    every key visible. Returns ``(out, cache)`` (None for cross).

    A local layer's cache no longer than its window is a ring of W slots,
    slot j holding position pos − ((pos − j) mod W): a decode step writes
    slot pos mod W and attends over the live slots ``[:min(pos + 1, W)]``
    — every one visible to the query, so their order does not matter; a
    prefill from position 0 attends over the prompt with window W, as a
    token-by-token fill of the ring would, and leaves its last W keys in
    their slots.

    With ``readonly`` (decode, t = 1; module docstring) ``cache`` is not
    written and the return is ``(out, {"k_new", "v_new", "pos"})``."""
    b, t, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    attn = dict(scale=dh ** -0.5, softcap=cfg.attn_logit_softcap)
    q = dense(p["q"], x).reshape(b, t, h, dh)
    if xattn_kv is not None:
        k, v = xattn_kv
        out = ops.flash_attention(q, k, v, causal=False, **attn)
        return dense(p["o"], out.reshape(b, t, h * dh)), None
    k = dense(p["k"], x).reshape(b, t, kvh, dh)
    v = dense(p["v"], x).reshape(b, t, kvh, dh)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rms")
        k = apply_norm(p["k_norm"], k, "rms")
    if cfg.rope == "std":
        pos2 = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
    elif cfg.rope == "mrope":
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, T) positions")
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if cache is not None and window is not None \
            and cache["k"].shape[1] <= window:
        w_sz = cache["k"].shape[1]
        if readonly:
            cache = {"k": cache["k"].clone(), "v": cache["v"].clone()}
        if t == 1:
            slot = pos % w_sz
            cache["k"][:, slot:slot + 1] = k
            cache["v"][:, slot:slot + 1] = v
            live = min(pos + 1, w_sz)
            out = ops.flash_attention(q, cache["k"][:, :live],
                                      cache["v"][:, :live], causal=False,
                                      **attn)
        elif pos == 0:
            out = ops.flash_attention(q, k, v, causal=True, window=w_sz,
                                      **attn)
            first = max(0, t - w_sz)
            slots = torch.arange(first, t, device=k.device) % w_sz
            cache["k"][:, slots] = k[:, first:]
            cache["v"][:, slots] = v[:, first:]
        else:
            raise ValueError(
                f"ring cache of a local layer: a prefill of {t} tokens at "
                f"position {pos} (only a prefill from position 0 or "
                f"one-token decode steps)")
        return dense(p["o"], out.reshape(b, t, h * dh)), cache
    if cache is not None and readonly:
        if t != 1:
            raise ValueError(f"the read-only cache is a decode-only path "
                             f"(one token a step), got {t} tokens")
        out = ops.flash_attention(q, cache["k"][:, :pos], cache["v"][:, :pos],
                                  causal=False, k_new=k, v_new=v, **attn)
        return (dense(p["o"], out.reshape(b, t, h * dh)),
                {"k_new": k, "v_new": v, "pos": pos + t})
    if cache is not None:
        cache["k"][:, pos:pos + t] = k
        cache["v"][:, pos:pos + t] = v
        if causal:
            k, v = cache["k"][:, :pos + t], cache["v"][:, :pos + t]
        else:
            # the JAX package's bidirectional attention over a cache sees
            # every slot of it, the unwritten ones included
            k, v = cache["k"], cache["v"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window, **attn)
    return dense(p["o"], out.reshape(b, t, h * dh)), cache


# ------------------------------------------------------------------ MLA
def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    c = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        # queries: full rank (the lite model has no q-LoRA)
        "q": dense_init(gen, d, h * (c.qk_nope_head_dim + c.rope_head_dim),
                        dtype, device),
        # the compressed kv and the shared rope key
        "dkv": dense_init(gen, d, c.kv_lora_rank, dtype, device),
        "k_rope": dense_init(gen, d, c.rope_head_dim, dtype, device),
        "kv_norm": norm_init(c.kv_lora_rank, "rms", dtype, device),
        # up-projections out of the latent
        "uk": dense_init(gen, c.kv_lora_rank, h * c.qk_nope_head_dim, dtype,
                         device),
        "uv": dense_init(gen, c.kv_lora_rank, h * c.v_head_dim, dtype,
                         device),
        "o": dense_init(gen, h * c.v_head_dim, d, dtype, device),
    }


def mla_cache(batch: int, cache_len: int, lat: int, rope: int, dtype,
              device) -> Params:
    """MLA's decode cache ``{"ckv": (batch, cache_len, lat), "k_rope":
    (batch, cache_len, rope)}`` of zeros: two views of one ``(batch,
    cache_len, lat + rope)`` buffer (:func:`latent_keys`)."""
    buf = torch.zeros((batch, cache_len, lat + rope), dtype=dtype,
                      device=device)
    return {"ckv": buf[..., :lat], "k_rope": buf[..., lat:]}


def latent_keys(ckv: torch.Tensor, k_rope: torch.Tensor,
                n: int) -> torch.Tensor:
    """The absorbed form's keys ``[ckv, k_rope]`` of the first ``n``
    positions as a ``(b, n, 1, lat + rope)`` view of :func:`mla_cache`'s
    buffer, read in place; raises on any other layout."""
    lat = ckv.shape[-1]
    if (ckv.stride() != k_rope.stride() or ckv.stride(-1) != 1
            or ckv.stride(1) != lat + k_rope.shape[-1]
            or k_rope.data_ptr() != ckv.data_ptr() + lat * ckv.element_size()):
        raise ValueError("an MLA cache must be mla_cache's layout (ckv and "
                         "k_rope views of one buffer), read in place")
    b, width = ckv.shape[0], lat + k_rope.shape[-1]
    return ckv.as_strided((b, n, 1, width),
                          (ckv.stride(0), ckv.stride(1), width, 1))


def mla_apply(
    p: Params, x: torch.Tensor, cfg: ArchConfig, *,
    positions: torch.Tensor, cache: Optional[Params] = None, pos: int = 0,
    readonly: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head latent attention, writing this step's latent and rope
    key into ``cache`` (``{"ckv", "k_rope"}``) at ``pos`` in place;
    returns ``(out, cache)``. Expanded form without a cache, absorbed
    with one (module docstring). With ``readonly`` (decode, t = 1) the
    cache, :func:`mla_cache`'s layout, is not written and the return is
    ``(out, {"ckv_new", "k_rope_new", "pos"})``."""
    c = cfg.mla
    b, t, _ = x.shape
    h, nope, rope, lat = (cfg.n_heads, c.qk_nope_head_dim, c.rope_head_dim,
                          c.kv_lora_rank)
    dq = nope + rope
    scale = dq ** -0.5
    q = dense(p["q"], x).reshape(b, t, h, dq)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = apply_norm(p["kv_norm"], dense(p["dkv"], x), "rms")   # (B, T, L)
    k_rope = dense(p["k_rope"], x).reshape(b, t, 1, rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        # absorbed: MQA over the latent, d = kv_lora + rope, v = k
        wuk = p["uk"]["w"].reshape(lat, h, nope)
        q_abs = torch.einsum("bthd,lhd->bthl", q_nope, wuk)
        qq = torch.cat([q_abs, q_rope], dim=-1)
        if readonly:
            if t != 1:
                raise ValueError(f"the read-only cache is a decode-only "
                                 f"path (one token a step), got {t} tokens")
            kk = latent_keys(cache["ckv"], cache["k_rope"], pos)
            kn = torch.cat([ckv, k_rope], dim=-1)[:, :, None, :]
            o_lat = ops.flash_attention(qq, kk, kk, causal=False,
                                        scale=scale, k_new=kn,
                                        v_new=kn)[..., :lat]
            new = {"ckv_new": ckv, "k_rope_new": k_rope, "pos": pos + t}
        else:
            cache["ckv"][:, pos:pos + t] = ckv
            cache["k_rope"][:, pos:pos + t] = k_rope
            kk = latent_keys(cache["ckv"], cache["k_rope"], pos + t)
            o_lat = ops.flash_attention(qq, kk, kk, causal=True,
                                        scale=scale)[..., :lat]
            new = cache
        wuv = p["uv"]["w"].reshape(lat, h, c.v_head_dim)
        out = torch.einsum("bthl,lhv->bthv", o_lat, wuv)
        return dense(p["o"], out.reshape(b, t, h * c.v_head_dim)), new
    # expanded: per-head keys and values out of the latent
    k_nope = dense(p["uk"], ckv).reshape(b, t, h, nope)
    v = dense(p["uv"], ckv).reshape(b, t, h, c.v_head_dim)
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(b, t, h, rope)],
                       dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    width = max(dq, c.v_head_dim)
    out = ops.flash_attention(
        F.pad(q_full, (0, width - dq)), F.pad(k_full, (0, width - dq)),
        F.pad(v, (0, width - c.v_head_dim)), causal=True,
        scale=scale)[..., :c.v_head_dim]
    return dense(p["o"], out.reshape(b, t, h * c.v_head_dim)), cache
