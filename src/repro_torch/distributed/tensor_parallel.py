"""Tensor parallelism over the mesh's ``"model"`` axis for serving the
decoders — where GSPMD's work stands in the JAX package, which places
heads, the FFN width, the experts and the vocabulary on ``"model"``
(``param_pspecs(mode="serve")``) and lets XLA insert the collectives.
The port has no compiler to propagate a layout, so it cuts the weights
itself and calls the collectives the block needs.

A serving replica is ``t`` model shards. Model shard ``m`` holds

* its heads ``[m·h/t, (m+1)·h/t)``: their q columns and o rows, whole
  heads (``t`` divides ``h``), and the kv heads they read: kv heads
  ``[m·kvh/t, (m+1)·kvh/t)`` where ``t`` divides ``kvh``, else (``t`` a
  multiple of ``kvh``) the one kv head ``m // (t / kvh)``, held by
  ``t / kvh`` shards — granite's single kv head on every shard, the JAX
  rule ``"kv"`` → ``None`` (its k / v projections replicated);
* its ``d_ff / t`` columns of gate and up and its rows of down, and so
  for every dense FFN of a MoE model: each shared expert (``expert_ff /
  t``), Arctic's parallel dense residual (``dense_residual_ff / t``) and
  deepseek's leading dense layer (``first_dense_ff / t``);
* its routed experts ``[m·E/t, (m+1)·E/t)``: the leading dim of the
  ``(E, D, F)`` / ``(E, F, D)`` stacks (``moe/(gate|up|down)``, the JAX
  rule ``("model", "fsdp", None)``), each expert whole;
* MLA's heads (``mla``): their columns of q (``(h, nope + rope)``, whole
  heads) and of the latent's up-projections uk / uv (``(lat, h, ·)``) and
  their rows of o; the latent projections dkv and k_rope, kv_norm and the
  latent cache whole on every shard (the cache does not shrink with
  ``t``, as in JAX, where they are not on ``"model"``);
* its ``V / t`` rows of the embedding and columns of the head, where
  ``t`` divides ``V``; else both whole (``param_pspecs``: a mesh axis
  that does not divide its dimension is dropped);
* the norms (and qwen3's q / k norms) and the router whole, and its kv
  heads' cache.

So a shard's q head ``i`` reads its local kv head ``i // (h/kvh)`` in
both cases, and every shard runs the model's own ``attn_apply`` /
``mla_apply`` and FFN on its tree with :func:`shard_config`'s view of
the config. The MoE FFN routes on every shard: the replica's shards hold
the same tokens after the psum, so each runs the whole router over all of
them, with the model's ``E``, capacity and choice-major slot order —
the same (expert, slot, kept) on every shard, bit for bit, and the same
as one device's, dropped choices included (C18) — then fills and runs
its own experts' buffers and combines the kept choices whose expert it
holds (``models.moe``). No all-to-all is needed. The outputs of o and of
the FFN (down's, or the routed, shared and dense partials summed on the
shard) are partial sums over the shard's heads, FFN columns or experts:
each comes out of its matrix product rounded to the model's dtype, and
the psum over the model comm (``comm.psum``) adds them in shard order
(each add rounded to the dtype) before the residual add
(``models.blocks.block_apply_tp``). The replica computes one device's
function up to that order: in float32 ~1e-7 of a logit's scale, in bf16
``t`` roundings of the partials and ``t − 1`` of the sums where one
device rounds the whole product once. The embedding's sum adds one
shard's rows to zeros, which is exact.

The entries follow ``distributed.sharding.param_pspecs(mode="serve")``'s
``"model"`` placements (its ``"data"`` entries do not apply: a data
replica holds its model shards whole, even the leaves the JAX serve
layout keeps over ``"data"`` past its 128 MiB budget — arctic's expert
stacks: ROADMAP A10d), except that q / k / v / o are cut at head
boundaries and MLA's dkv stays whole: the rules' ``(k|v)/w$`` entry
matches ``dkv/w`` before their own ``(dkv|k_rope)/w$`` one and puts the
latent's columns on ``"model"``, which XLA gathers back; the port keeps
the latent whole, as the rules table's own entry says. Full trees stay
the interchange: ``shard_params_tp`` cuts a whole tree (``init_params``,
``models.params_from_jax``, a checkpoint).

Training over ``"model"`` (``train.fsdp`` on a ``("data", "model")``
mesh) cuts each leaf the same way (:func:`tp_slices`) and then over the
data axes. A model shard's gradient of its part is whole, but for two
kinds of leaf (:func:`tp_holders`, :func:`tp_partial`):

* **partial** on each holder, summed over exactly its holders by the
  trainer: qwen3's per-head ``q_norm`` / ``k_norm`` (every shard applies
  them to its own heads: summed over all ``t``), and a kv head held by
  ``t / kvh`` shards (``t`` a multiple of ``kvh``: granite's one kv head
  on every shard, each reduced config's two kv heads at ``t = 4``), each
  holder's ``k`` / ``v`` gradient coming from its own q heads;
* **whole on every shard** by the conjugate pair
  (``distributed.mesh.psum_bwd`` where a replicated activation enters a
  column-cut projection sums the shards' input gradients): the norms
  (``norm1``, ``norm2``, ``final_norm``), and an embedding and head kept
  whole (``t`` not dividing ``V``), which every shard computes
  redundantly from its whole loss.

Not yet split (:func:`unsplit_blocks`): for training, MoE experts and
MLA's latent heads (ROADMAP A10e: their gradients over ``"model"`` are
not checked yet); for serving and training, the recurrent and local
kinds, cross-attention, absolute positions and the vision merge (ROADMAP
A10c).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ATTN, ArchConfig, ShardMoEConfig
from ..tree import get_path, path_str, tree_map_with_path
from .mesh import Mesh
from .sharding import param_pspecs

__all__ = ["unsplit_blocks", "unsplit_label", "tp_degree", "shard_config", "shard_params_tp",
           "tp_slices", "tp_holders", "tp_partial",
           "gather_vocab", "embed_lookup"]


_MODES = ("serve", "train")
_ALL = "ROADMAP A10c"          # blocks that no mode splits yet
_TRAIN_ONLY = "ROADMAP A10e"   # MoE / MLA: split for serving, not training


def unsplit_blocks(cfg: ArchConfig, mode: str = "serve") -> List[str]:
    """What of ``cfg``'s model has no split over ``"model"`` yet for
    ``mode`` (``"serve"`` or ``"train"``): empty for a dense decoder, and
    for serving a MoE or MLA one."""
    if mode not in _MODES:
        raise ValueError(f"mode is 'serve' or 'train', got {mode!r}")
    out = []
    if mode == "train" and cfg.moe is not None:
        out.append("MoE experts")
    if mode == "train" and cfg.mla is not None:
        out.append("MLA latent heads")
    other = sorted({kind.replace("_dense", "")
                    for unit, _ in cfg.layout() for kind in unit} - {ATTN})
    if other:
        out.append(f"layer kinds {other}")
    if cfg.n_enc_layers:
        out.append("cross-attention over an encoder")
    if cfg.n_vision_embeds or cfg.rope == "mrope":
        out.append("the vision merge (M-RoPE)")
    if cfg.rope == "none" and cfg.abs_pos:
        out.append("absolute position embeddings")
    return out


def unsplit_label(cfg: ArchConfig, mode: str = "serve") -> str:
    """The ROADMAP item that splits what :func:`unsplit_blocks` lists
    (``""`` where it lists nothing): A10c for blocks no mode splits yet,
    A10e for MoE / MLA in training."""
    rest = unsplit_blocks(cfg, mode)
    if not rest:
        return ""
    return _ALL if unsplit_blocks(cfg, "serve") else _TRAIN_ONLY


def _ffn_widths(cfg: ArchConfig) -> Tuple[int, ...]:
    """The FFN widths a shard cuts ``t`` ways: ``d_ff`` and, for a MoE
    model, the experts, the shared experts' width, the dense residual's
    and the leading dense layer's."""
    mo = cfg.moe
    if mo is None:
        return (cfg.d_ff,)
    return (cfg.d_ff, mo.n_experts, mo.expert_ff, mo.dense_residual_ff,
            mo.first_dense_ff)


def _fits(cfg: ArchConfig, t: int) -> bool:
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    return (h % t == 0 and (kvh % t == 0 or t % kvh == 0)
            and all(w % t == 0 for w in _ffn_widths(cfg)))


def tp_degree(cfg: ArchConfig, t: int, mode: str = "serve") -> int:
    """The largest extent ``u ≤ t`` that splits ``cfg`` at head
    boundaries: ``u`` divides the heads, the FFN widths and the experts
    (:func:`_ffn_widths`), and divides or is a multiple of the kv heads.
    Raises for an arch whose blocks are not yet split for ``mode``
    (:func:`unsplit_blocks`)."""
    rest = unsplit_blocks(cfg, mode)
    if rest:
        what = ("splits the dense decoder, MoE and MLA blocks only"
                if unsplit_label(cfg, mode) == _ALL else
                "serves MoE and MLA blocks but does not train them")
        raise ValueError(f"{cfg.name}: tensor parallelism over 'model' "
                         f"{what}; {', '.join(rest)} are not split for "
                         f"{mode} yet ({unsplit_label(cfg, mode)})")
    if t < 1:
        raise ValueError(f"a model axis of {t}")
    return next(u for u in range(t, 0, -1) if _fits(cfg, u))


def shard_config(cfg: ArchConfig, t: int, mode: str = "serve"
                 ) -> ArchConfig:
    """A model shard's view of ``cfg`` at extent ``t``: its heads, kv
    heads and FFN widths, ``head_dim`` pinned to the whole model's (an
    unset ``head_dim`` is ``d_model // n_heads``, which a shard's fewer
    heads would change); a MoE config's view keeps the model's
    ``n_experts`` and ``expert_ff`` (each routed expert is whole on its
    shard) and says which experts a shard holds
    (``configs.base.ShardMoEConfig``). Raises unless ``tp_degree(cfg, t,
    mode) == t``."""
    if tp_degree(cfg, t, mode) != t:
        widths = ", ".join(str(w) for w in _ffn_widths(cfg) if w)
        raise ValueError(
            f"{cfg.name} does not split {t} ways at head boundaries "
            f"(heads {cfg.n_heads}, kv heads {cfg.n_kv_heads}, FFN widths "
            f"and experts {widths}); the largest extent up to {t} is "
            f"{tp_degree(cfg, t, mode)}")
    moe = cfg.moe
    if moe is not None:
        moe = ShardMoEConfig(**dict(
            dataclasses.asdict(moe),
            dense_residual_ff=moe.dense_residual_ff // t,
            first_dense_ff=moe.first_dense_ff // t), expert_shards=t)
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // t,
        n_kv_heads=max(cfg.n_kv_heads // t, 1), d_ff=cfg.d_ff // t,
        head_dim=cfg.dh, moe=moe)


_KV = re.compile(r"(^|/)(k|v)/w$")
_QK_NORM = re.compile(r"(^|/)(q_norm|k_norm)/scale$")
# MLA's latent projection: whole on every shard (module docstring)
_LATENT = re.compile(r"(^|/)dkv/w$")


def _model_spec(path, spec, cfg: ArchConfig):
    """``spec`` with the ``"model"`` entries the port does not cut
    dropped (MLA's dkv)."""
    if cfg.mla is not None and _LATENT.search(path_str(path)):
        return tuple(None if e == "model" else e for e in spec)
    return tuple(spec)


def _kv_cut(path, cfg: ArchConfig, t: int) -> bool:
    """Whether the leaf at ``path`` is a k / v projection whose kv heads
    are fewer than the shards (each shard holds the one its q heads
    read)."""
    return t > cfg.n_kv_heads and bool(_KV.search(path_str(path)))


def tp_slices(shape: Sequence[int], path, spec, cfg: ArchConfig, t: int,
              m: int) -> Tuple[slice, ...]:
    """Model shard ``m``'s index ranges of the leaf at ``path`` (a tree
    path; an optimizer state's path ends as its parameter's) of
    ``shape``, placed as ``spec`` by ``param_pspecs`` on a mesh whose
    ``"model"`` axis has extent ``t`` (module docstring)."""
    sl = [slice(None)] * len(shape)
    for d, entry in enumerate(_model_spec(path, spec, cfg)):
        if entry == "model":
            size = shape[d] // t
            sl[d] = slice(m * size, (m + 1) * size)
    if _kv_cut(path, cfg, t):
        g = m // (t // cfg.n_kv_heads)     # the kv head of m's q heads
        sl[-1] = slice(g * cfg.dh, (g + 1) * cfg.dh)
    return tuple(sl)


def tp_holders(path, spec, cfg: ArchConfig, t: int) -> List[List[int]]:
    """The model shards that hold the same part of the leaf at ``path``
    (placed as ``spec``), in groups: one shard a group for a leaf cut
    over ``"model"``, the ``t / kvh`` shards of each kv head for a k / v
    projection with fewer kv heads than shards, else every shard."""
    if "model" in _model_spec(path, spec, cfg):
        return [[m] for m in range(t)]
    if _kv_cut(path, cfg, t):
        r = t // cfg.n_kv_heads
        return [list(range(g * r, (g + 1) * r))
                for g in range(cfg.n_kv_heads)]
    return [list(range(t))]


def tp_partial(path, cfg: ArchConfig, t: int) -> bool:
    """Whether each holder's gradient of the leaf at ``path`` is a
    partial sum that the trainer adds up over its holders (qwen3's
    ``q_norm`` / ``k_norm``, a kv head on several shards), rather than
    whole (module docstring)."""
    return t > 1 and (bool(_QK_NORM.search(path_str(path)))
                      or _kv_cut(path, cfg, t))


def shard_params_tp(params: Any, cfg: ArchConfig, mesh: Mesh, *,
                    shards: Optional[Sequence[int]] = None,
                    device=None) -> List[Any]:
    """``params`` (a whole tree of ``cfg``) cut for the mesh's shards
    ``shards`` (every shard by default) along its ``"model"`` axis (module
    docstring): one tree a shard, each leaf a contiguous copy on the
    shard's device (``device``, if given, for every shard)."""
    t = mesh.shape.get("model", 1)
    shard_config(cfg, t)               # raises unless t splits cfg
    specs = param_pspecs(params, mesh, mode="serve",
                         kv_heads_divide=cfg.n_kv_heads % t == 0, cfg=cfg)
    shards = range(mesh.size) if shards is None else shards

    def part(path, x, m: int) -> torch.Tensor:
        return x[tp_slices(x.shape, path, get_path(specs, path), cfg, t,
                           m)]

    out = []
    for j in shards:
        m = mesh.coords(j).get("model", 0)
        dev = mesh.devices[j] if device is None else device
        out.append(tree_map_with_path(
            lambda p, x: part(p, x, m).to(dev, copy=True).contiguous(),
            params))
    return out


def gather_vocab(comm, xs: Sequence[torch.Tensor],
                 vocab: int) -> List[torch.Tensor]:
    """Every shard's ``(..., V / t)`` logits gathered into ``(..., V)``,
    shard m's columns at ``[m·V/t, (m+1)·V/t)`` (an all-gather); logits
    that are already ``vocab`` wide (a head kept whole) come back as
    they are."""
    if xs[0].shape[-1] == vocab:
        return list(xs)
    return [y.movedim(0, -2).reshape(*y.shape[1:-1], -1)
            for y in comm.all_gather(list(xs))]


def embed_lookup(embed: torch.Tensor, ids: torch.Tensor,
                 m: int) -> torch.Tensor:
    """Model shard ``m``'s part of the embedding lookup: the rows of the
    ids in its range ``[m·n, (m+1)·n)`` (``n`` its rows), zeros for the
    others, which no index reads out of bounds."""
    n = embed.shape[0]
    local = ids - m * n
    hit = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)]
    return torch.where(hit[..., None], rows, rows.new_zeros(()))
