"""Serving: prefill + decode steps and a batched request loop, PyTorch
port of the JAX package's ``serve.serve_step``.

``make_serve_step`` returns the two stages:
  prefill_step(params, tokens, cache, **extra) → (logits_last, cache)
  decode_step(params, token, cache, **extra)   → (logits, cache)
(``extra``: whisper's ``enc_out`` or ``enc_frames``, qwen2-vl's
``vision_embeds``).
``BatchedServer`` slots requests into fixed batch lanes a wave at a
time. It mirrors the JAX loop step for step, including what that loop
does on purpose or by accident: prompts are left-padded with token 0 and
the pads are attended (there is no pad mask); every wave ends with one
decode whose logits are never used; sampling at temperature > 0 draws
from a ``torch.Generator``, so only greedy decoding is comparable with
the JAX package token for token. The cache position is a host int. It
passes no ``extra``, so it serves every family but whisper (which needs
the encoder's output: drive ``make_serve_step`` with ``enc_out=``) and
qwen2-vl as text only, as the JAX loop does.

A tensor-parallel replica (``comm=``, a model comm; the dense decoders
and the MoE ones with MLA, ``distributed.tensor_parallel``): the steps take the shards' trees and
caches (one a shard of ``comm.shards``) and return the served position's
logits gathered across the shards (``gather_vocab``: only that position
crosses, never ``(B, T, V)``), on the first shard's device; the server
samples and runs its hook once, on those logits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed.tensor_parallel import gather_vocab
from ..models import ModelOptions, forward, init_cache

__all__ = ["ServeConfig", "make_serve_step", "make_knn_hook", "sample",
           "BatchedServer"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    cache_len: int = 2048
    temperature: float = 0.0      # 0 → greedy
    eos_id: int = -1              # -1 → run to max_new_tokens


def make_serve_step(cfg: ArchConfig, scfg: ServeConfig,
                    opts: ModelOptions = ModelOptions(), *, comm=None):
    """The two stages; with a model ``comm`` over a tensor-parallel
    replica's shards (module docstring)."""
    def last(logits):
        if comm is None:
            return logits[:, -1]
        return gather_vocab(comm, [x[:, -1] for x in logits], cfg.vocab)[0]

    def prefill_step(params, tokens, cache, **extra):
        """tokens (B, T_prompt); fills the cache, returns the last
        position's logits. ``extra`` goes to ``forward`` (``enc_frames``,
        ``enc_out``, ``vision_embeds``)."""
        logits, cache = forward(params, cfg, tokens, cache=cache,
                                opts=opts, mode="prefill", comm=comm,
                                **extra)
        return last(logits), cache

    def decode_step(params, token, cache, **extra):
        """token (B, 1); one step against the cache."""
        logits, cache = forward(params, cfg, token, cache=cache,
                                opts=opts, mode="decode", comm=comm, **extra)
        return last(logits), cache

    return prefill_step, decode_step


def make_knn_hook(store, kcfg, vocab: int, *, scheduler=None,
                  deadline_s: Optional[float] = None,
                  query_fn: Optional[Callable] = None) -> Callable:
    """A ``logits_hook`` for :class:`BatchedServer` that interpolates each
    step's logits with kNN-LM retrieval from ``store`` (a
    ``serve.Datastore``) — optionally *through* a
    ``serve.scheduler.ServeScheduler`` (``scheduler=``, with
    ``deadline_s=``), which puts admission control, deadlines and
    graceful degradation in front of the retrieval join: an overloaded
    or past-deadline step falls back to the LM distribution alone.
    ``query_fn(logits, cache) -> (B, D) float32`` maps the decode state
    to retrieval queries; the default takes the leading logit slice, as
    the JAX package's (a stand-in for the hidden state)."""
    from .retrieval import interpolate, knn_logits

    if query_fn is None:
        dim = store.keys.shape[1]

        def query_fn(logits, cache):
            return logits[:, :dim].to(torch.float32).cpu().numpy()

    def hook(logits, cache):
        q = query_fn(logits, cache)
        lg = knn_logits(q, store, kcfg, vocab, scheduler=scheduler,
                        deadline_s=deadline_s)
        return interpolate(logits, lg, kcfg.lam)

    return hook


def sample(logits: torch.Tensor, temperature: float,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (argmax) at temperature 0, else a categorical draw from
    ``softmax(logits / temperature)`` with ``gen``. int32 tokens."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


class BatchedServer:
    """Host-side batching over fixed lanes, a wave of ``scfg.batch``
    requests at a time, on the device the parameters live on. A
    tensor-parallel replica passes its shards' trees as ``params`` and
    their model ``comm``; sampling and the hook run on the first shard's
    device."""

    def __init__(self, cfg: ArchConfig, scfg: ServeConfig, params,
                 opts: ModelOptions = ModelOptions(),
                 logits_hook: Optional[Callable] = None, *,
                 generator: Optional[torch.Generator] = None, comm=None):
        self.cfg, self.scfg, self.opts = cfg, scfg, opts
        self.params, self.comm = params, comm
        self.device = (params["embed"].device if comm is None
                       else comm.device(comm.shards[0]))
        self.prefill_step, self.decode_step = make_serve_step(
            cfg, scfg, opts, comm=comm)
        self.logits_hook = logits_hook   # e.g. kNN-LM interpolation
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)

    def generate(self, prompts: List[np.ndarray], max_new_tokens: int
                 ) -> List[np.ndarray]:
        """Generate for all prompts, ``scfg.batch`` lanes at a time."""
        out: List[np.ndarray] = [None] * len(prompts)
        queue = list(enumerate(prompts))
        while queue:
            wave = queue[: self.scfg.batch]
            queue = queue[self.scfg.batch:]
            ids = [i for i, _ in wave]
            toks = [np.asarray(p, np.int32) for _, p in wave]
            tmax = max(len(t) for t in toks)
            b = len(wave)
            pad = np.zeros((b, tmax), np.int32)
            for r, t in enumerate(toks):
                pad[r, tmax - len(t):] = t   # left-pad → aligned last pos
            cache = init_cache(self.cfg, b, tmax + max_new_tokens, self.opts,
                               device=self.device, comm=self.comm)
            logits, cache = self.prefill_step(
                self.params, torch.as_tensor(pad, device=self.device), cache)
            gen = np.zeros((b, max_new_tokens), np.int32)
            for step in range(max_new_tokens):
                if self.logits_hook is not None:
                    logits = self.logits_hook(logits, cache)
                tok = sample(logits, self.scfg.temperature, self.generator)
                gen[:, step] = tok.cpu().numpy()
                logits, cache = self.decode_step(self.params, tok[:, None],
                                                 cache)
            for r, i in enumerate(ids):
                out[i] = gen[r]
        return out
