"""Mixture-of-Experts FFN (Arctic's dense + MoE hybrid, DeepSeek's
shared experts) with capacity-bounded dispatch — PyTorch port of the
JAX package's ``models.moe``.

The function is the JAX package's ``moe_apply`` / ``_moe_tokens``:

* **Router.** Logits from ``dense`` in the model dtype, then float32;
  softmax; the top-k experts of each token in descending gate order
  with ties to the lower expert index (``jax.lax.top_k``'s rule — a
  stable descending sort, since ``torch.topk`` orders no ties); the
  k weights renormalised by ``max(sum, 1e-9)``.
* **Capacity.** ``cap = max(1, int(top_k · n · capacity_factor / E))``
  slots per expert, filled in choice-major order (every token's first
  choice, in token order, before any second choice); a (token, choice)
  past its expert's capacity is dropped. At decode this drops a lot:
  deepseek-v2-lite at batch 8 has cap 1.
* **Chunking.** Above ``_MOE_CHUNK`` tokens, and only when the count is
  a multiple of it, routing runs per chunk of ``_MOE_CHUNK`` tokens
  (capacity is per chunk, so this changes which tokens drop).
* **Dispatch.** PyTorch's idiom instead of the JAX one-hot einsums: the
  kept tokens are indexed into an ``(E, C, D)`` buffer, the experts run
  as batched matrix products, and each token sums its kept choices'
  outputs weighted by its gate weights rounded to the model dtype (as
  JAX rounds its combine tensor), accumulated in float32 and rounded
  once.

Shared experts and Arctic's parallel dense residual add their MLPs to
the routed output.

A tensor-parallel model shard (``shard=m`` of a config whose ``moe`` is
a shard's view, ``distributed.tensor_parallel.shard_config``) holds the
routed experts ``cfg.moe.experts_of(m)`` and its columns of the shared
and dense MLPs. It routes as one device does — the whole router over
all the tokens with the model's ``E`` and capacity, so the (expert,
slot, kept) of every (token, choice) are one device's — and then fills
and runs only its own experts' ``(E/t, C, D)`` buffers, and combines
only the kept choices whose expert it holds (in float32, rounded once).
Its output is a partial sum that the replica's psum completes
(``models.blocks.block_apply_tp``). The router's top-k reaches no ``pallas_call`` in the
JAX package, so nothing here is a kernel: the expert products are plain
``torch.bmm``, as the JAX package's are plain ``einsum``.

:data:`drop_log`, when set to a list, receives ``(kept, routed)`` per
routed block (a counter for scripts that print the dropped share; a
tensor-parallel replica's blocks are counted once, by shard 0), and
:data:`route_log` ``(shard, experts, slots, kept)`` per routed block and
shard (what a check of the shards' routing compares).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import dense, dense_init, mlp_apply, mlp_init, normal_init

__all__ = ["moe_init", "moe_apply", "moe_route", "drop_log", "route_log"]

Params = Dict[str, Any]

_MOE_CHUNK = 4096   # tokens per routed block (the JAX package's)

# (kept, routed) (token, choice) pairs per routed block, when a list
drop_log: Optional[List[Tuple[int, int]]] = None
# (shard, experts, slots, kept) per routed block and shard, when a list
route_log: Optional[list] = None


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device) -> Params:
    mo = cfg.moe
    d = cfg.d_model
    up = (mo.n_experts, d, mo.expert_ff)
    p: Params = {
        "router": dense_init(gen, d, mo.n_experts, dtype, device,
                             scale=0.02),
        "up": normal_init(gen, up, d ** -0.5, dtype, device),
        "down": normal_init(gen, (mo.n_experts, mo.expert_ff, d),
                            mo.expert_ff ** -0.5, dtype, device),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["gate"] = normal_init(gen, up, d ** -0.5, dtype, device)
    if mo.n_shared:
        p["shared"] = [mlp_init(gen, cfg, mo.expert_ff, dtype, device)
                       for _ in range(mo.n_shared)]
    if mo.dense_residual_ff:
        p["dense"] = mlp_init(gen, cfg, mo.dense_residual_ff, dtype, device)
    return p


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              shard: int = 0) -> torch.Tensor:
    """x (B, T, D) → (B, T, D); on a tensor-parallel model shard
    ``shard`` its partial sum (module docstring)."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    if n > _MOE_CHUNK and n % _MOE_CHUNK == 0:
        y = torch.cat([_moe_tokens(p, xf[lo:lo + _MOE_CHUNK], cfg, shard)
                       for lo in range(0, n, _MOE_CHUNK)])
    else:
        y = _moe_tokens(p, xf, cfg, shard)
    y = y.reshape(b, t, d)
    for sp in p.get("shared", []):
        y = y + mlp_apply(sp, x, cfg.act)
    if "dense" in p:
        y = y + mlp_apply(p["dense"], x, cfg.act)
    return y


def moe_route(p: Params, xf: torch.Tensor, cfg: ArchConfig):
    """The routing of a flat (N, D) block: ``(experts (N, k) int64,
    slots (N, k) int64, kept (N, k) bool, weights (N, k) float32, cap)``
    — each (token, choice)'s expert, its position in that expert's
    buffer and whether it fits, and the renormalised gate weights."""
    mo = cfg.moe
    n = xf.shape[0]
    e, k = mo.n_experts, mo.top_k
    cap = max(1, int(k * n * mo.capacity_factor / e))
    logits = dense(p["router"], xf).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # choice-major order: all first choices (token order), then seconds
    flat = tope.T.reshape(-1)                                   # (k·N,)
    onehot = F.one_hot(flat, e)
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat[:, None])[:, 0]
    slots = slot.reshape(k, n).T
    return tope, slots, slots < cap, topw, cap


def _moe_tokens(p: Params, xf: torch.Tensor, cfg: ArchConfig,
                shard: int = 0) -> torch.Tensor:
    """Routed-expert compute for a flat (N, D) token block: the experts
    of model shard ``shard`` (every expert on one device)."""
    n, d = xf.shape
    own = cfg.moe.experts_of(shard)
    e, lo = len(own), own.start
    if p["up"].shape[0] != e:
        raise ValueError(f"shard {shard} holds {p['up'].shape[0]} experts, "
                         f"its config view {e}")
    tope, slots, kept, topw, cap = moe_route(p, xf, cfg)
    if drop_log is not None and shard == 0:
        drop_log.append((int(kept.sum()), kept.numel()))
    if route_log is not None:
        route_log.append((shard, tope, slots, kept))
    if e != cfg.moe.n_experts:        # the kept choices of own experts
        kept = kept & (tope >= lo) & (tope < lo + e)
        tope = torch.clamp(tope - lo, 0, e - 1)
    tok = torch.arange(n, device=xf.device)[:, None].expand_as(tope)
    xe = torch.zeros((e, cap, d), dtype=xf.dtype, device=xf.device)
    xe[tope[kept], slots[kept]] = xf[tok[kept]]
    if "gate" in p:
        he = F.silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    else:
        he = torch.square(F.relu(torch.bmm(xe, p["up"])))
    ye = torch.bmm(he, p["down"])                               # (E, C, D)
    w = (topw * kept).to(xf.dtype).to(torch.float32)
    picked = ye[tope, torch.clamp(slots, max=cap - 1)].to(torch.float32)
    return (w[..., None] * picked).sum(1).to(xf.dtype)
