"""Training step: loss, gradient accumulation, remat — PyTorch port of the
JAX package's ``train.train_step``.

Memory contract: with ``ModelOptions.remat`` (``torch.utils.checkpoint``
per layer) the per-microbatch activations of one layer live on the card
at a time, and ``accum`` scales the global batch without scaling
memory. Gradients come from ``torch.autograd.grad``; attention's from
K-B (``kernels.ops.flash_attention`` routes through
``FlashAttentionFn`` whenever its inputs require grad).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..models import ModelOptions, forward
from .optimizer import OptConfig, make_optimizer
from ..tree import leaves, tree_map

__all__ = ["TrainConfig", "cross_entropy", "loss_fn", "loss_and_grads",
           "make_train_step"]

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum: int = 1               # gradient-accumulation microbatches
    z_loss: float = 1e-4         # logit normalizer regularizer (PaLM-style)
    # f32 accumulation is the default; bf16 halves the accumulator memory
    accum_dtype: Any = torch.float32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token CE (+ z-loss). logits (B, T, V) f32, labels (B, T)
    integer. Labels < 0 are masked."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0).to(
        torch.int64)[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    denom = torch.clamp(mask.sum(), min=1)
    return (nll * mask).sum() / denom


def loss_fn(params, cfg: ArchConfig, batch: Batch, opts: ModelOptions,
            z_loss: float = 0.0) -> torch.Tensor:
    extra = {k: batch[k] for k in ("enc_frames", "vision_embeds", "positions")
             if k in batch}
    logits, _ = forward(params, cfg, batch["tokens"], opts=opts,
                        mode="train", **extra)
    return cross_entropy(logits, batch["labels"], z_loss)


def loss_and_grads(params, cfg: ArchConfig, batch: Batch, opts: ModelOptions,
                   z_loss: float = 0.0) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of :func:`loss_fn` at ``params`` (the counterpart
    of ``jax.value_and_grad(loss_fn)``); ``params`` are not modified."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, cfg, batch, opts, z_loss)
        grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), live)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    opts: ModelOptions = ModelOptions()):
    """Returns ``(opt_init, train_step)``; ``train_step(params, opt_state,
    batch) → (params, state, metrics)``.

    ``batch["tokens"]`` is (accum, mb, T) when tcfg.accum > 1: the
    microbatches' gradients are summed in ``accum_dtype`` before one
    optimizer application, then divided by ``accum``."""
    opt_init, opt_update = make_optimizer(tcfg.opt, cfg)

    def train_step(params, opt_state, batch: Batch):
        if tcfg.accum == 1:
            loss, grads = loss_and_grads(params, cfg, batch, opts,
                                         tcfg.z_loss)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=tcfg.accum_dtype, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(tcfg.accum):
                mb = {k: v[i] for k, v in batch.items()}
                mb_loss, mb_grads = loss_and_grads(params, cfg, mb, opts,
                                                   tcfg.z_loss)
                tree_map(lambda a, g: a.add_(g.to(tcfg.accum_dtype)), grads,
                         mb_grads)
                loss = loss + mb_loss
                del mb_grads
            grads = tree_map(lambda g: g / tcfg.accum, grads)
            loss = loss / tcfg.accum
        new_params, new_state, om = opt_update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss, **om}

    return opt_init, train_step
