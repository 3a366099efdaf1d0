"""Per-(arch × shape) step builders over meta tensors — PyTorch port of
the JAX package's ``launch.specs``.

:func:`build_cell` returns what the dry run (``launch.dryrun``) needs:
one device's step function and its inputs, made as meta tensors
(``launch.cost``: shapes and dtypes, no data and no allocation; the JAX
package's ``ShapeDtypeStruct``\\ s). The steps are
the programs the port runs, not what XLA would make of the JAX package:

- **train** (:func:`build_train_cell`): on a mesh of several devices,
  ``train.fsdp.FSDPTrainer``'s step for one rank (rank 0) over
  :class:`launch.cost.RecordingComm` — what ``launch/train.py --shards
  N [--tp T]`` runs on each card: the gather of its model shard's tree
  over its data group (the whole model where the mesh has no model
  axis), forward and backward on its replica's rows (over a model axis,
  the TP forward's all-reduces and the vocab-parallel loss within the
  node, recorded over NVLink), the float32 reduce-scatter over the data
  group (across nodes, the network), the rank's AdamW part; on one
  device, ``train.make_train_step``'s step (``launch/train.py`` without
  ``--shards``);
- **prefill** and **decode** (:func:`build_prefill_cell`,
  :func:`build_decode_cell`): on a mesh whose ``"model"`` axis is wider
  than 1 (the dense and the MoE decoders, ``launch.mesh.model_extent``),
  rank 0's shard of a tensor-parallel replica (``launch/serve.py --tp t``
  on each card): ``models.forward`` over rank 0's cut of the weights
  (``tensor_parallel.shard_params_tp``: its heads, FFN columns and
  experts) and its kv heads' cache (MLA's whole latent), its all-reduces
  (a MoE FFN's one psum, where GSPMD's layout would exchange the tokens
  all to all) and the served position's logit gather recorded by a
  :class:`launch.cost.RecordingComm` of ``t`` ranks; else one
  data-parallel replica with whole weights, as ``launch/serve.py``
  runs on each card. A replica holds its model shards whole: the leaves
  that the JAX serve layout keeps over ``"data"`` past its 128 MiB
  budget (``param_pspecs(mode="serve")``) are not placed so
  (``Cell.held_whole``, which a record that does not fit names: ROADMAP
  A10d).

As in the JAX package: bf16 weights, remat for train, the read-only
cache for decode (``model_options``; its ``chunk_q`` has no counterpart:
K-F runs every length); Adafactor with bf16 gradient accumulation above
100e9 parameters, AdamW below; one sequence a data replica and ``accum
= global_batch // replicas`` microbatches; the batch split over the data
axes where it divides them, replicated where it does not (decode_32k's
128 rows over 256 replicas), as JAX's ``bspec``. A decode step enters
with a full cache (position ``cache_len − 1``).

The train rank's batch: ``FSDPTrainer.step`` takes the global batch and
cuts its data replica's rows from it (the same rows on every model
shard of a replica). A rank's card holds only its own rows, so the
global batch is given as a view of the rank's rows with the global
shape (stride 0 along the rows): the rows the rank cuts are its own, and
its device's arguments are its rows, as the JAX dry run's per-device
batch is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..distributed.mesh import Mesh
from ..distributed.sharding import param_pspecs
from ..distributed.tensor_parallel import (gather_vocab, shard_config,
                                           shard_params_tp)
from ..models import ModelOptions, forward, init_cache, init_params
from ..train import OptConfig, TrainConfig, make_train_step
from ..tree import get_path, leaves_with_path
from .cost import RecordingComm, abstract
from .mesh import NODE_CARDS

__all__ = ["Cell", "model_options", "META", "abstract_params",
           "build_train_cell", "build_prefill_cell", "build_decode_cell",
           "build_cell"]

# archs whose AdamW state cannot fit (12 B a parameter) train with
# Adafactor and bf16 gradient accumulation, as in the JAX package
_ADAFACTOR_ABOVE = 100e9


@dataclasses.dataclass
class Cell:
    """One (arch × shape × mesh) cell: ``step_fn(*abstract_args)`` is one
    device's step, its inputs meta tensors; ``comm`` records the step's
    collectives (train cells over a mesh)."""
    arch: ArchConfig
    shape: ShapeConfig
    opts: ModelOptions
    step_fn: Callable
    abstract_args: Tuple
    kind: str                    # train | prefill | decode
    comm: Optional[RecordingComm] = None
    notes: str = ""
    # bytes of the device's weights that the JAX serve layout keeps over
    # "data" and the port's replica holds whole (module docstring)
    held_whole: int = 0


META = torch.device("meta")


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _replicas(mesh: Mesh) -> int:
    """The data replicas (the batch axes' product; a ``"model"`` axis is
    tensor parallelism within a replica)."""
    others = {a: n for a, n in mesh.shape.items()
              if a not in ("pod", "data", "model") and n != 1}
    if others:
        raise ValueError(f"mesh axes {others} have no place in the port's "
                         f"layouts (batch over 'pod' / 'data', tensor "
                         f"parallelism over 'model')")
    return math.prod(mesh.shape[a] for a in _batch_axes(mesh))


def model_options(arch: ArchConfig, shape: ShapeConfig) -> ModelOptions:
    return ModelOptions(
        dtype=torch.bfloat16,
        remat=shape.kind == "train",
        max_abs_pos=max(4096, shape.seq_len + shape.cache_len + 1),
        readonly_cache=shape.kind == "decode",
    )


def abstract_params(arch: ArchConfig, opts: ModelOptions):
    """The model's parameters as meta tensors (``init_params``' shapes
    and dtypes; nothing drawn)."""
    return abstract(init_params, arch, torch.Generator().manual_seed(0),
                    opts, device="cpu")


def _extras(arch: ArchConfig, lead: Tuple[int, ...], seq: int,
            kind: str) -> Dict[str, torch.Tensor]:
    """Whisper's encoder input (its frames; at decode the encoder's
    output, as the port serves it), qwen2-vl's vision embeddings (not at
    decode) and M-RoPE positions (not in train, where the model's own
    positions serve), for rows ``lead``."""
    out: Dict[str, torch.Tensor] = {}
    bf16 = torch.bfloat16
    if arch.n_enc_layers:
        out["enc_out" if kind == "decode" else "enc_frames"] = torch.empty(
            lead + (arch.enc_len, arch.d_model), dtype=bf16, device=META)
    if arch.rope == "mrope":
        if kind != "train":
            out["positions"] = torch.empty((3,) + lead + (seq,),
                                           dtype=torch.int32, device=META)
        if kind != "decode":
            out["vision_embeds"] = torch.empty(
                lead + (arch.n_vision_embeds, arch.d_model), dtype=bf16,
                device=META)
    return out


def build_train_cell(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
                     rows: int = 1) -> Cell:
    """One rank's train step (module docstring); ``rows`` sequences a
    data replica a microbatch (the JAX package's 1)."""
    opts = model_options(arch, shape)
    nb = _replicas(mesh)
    mb_global = nb * rows
    accum = max(1, shape.global_batch // mb_global)
    big = arch.param_count() > _ADAFACTOR_ABOVE
    tcfg = TrainConfig(
        opt=OptConfig(name="adafactor" if big else "adamw"), accum=accum,
        accum_dtype=torch.bfloat16 if big else torch.float32)
    comm = None
    params = abstract_params(arch, opts)
    lead = (accum,) if accum > 1 else ()
    local_rows = {k: torch.empty(lead + (rows, shape.seq_len),
                                 dtype=torch.int32, device=META)
                  for k in ("tokens", "labels")}
    local_rows.update(_extras(arch, lead + (rows,), shape.seq_len, "train"))
    if mesh.size == 1:
        opt_init, step = make_train_step(arch, tcfg, opts)
        args = (params, opt_init(params), local_rows)
        layout = "one device"
    else:
        from ..train.fsdp import FSDPTrainer
        if rows != 1:
            raise ValueError("the sharded step takes one sequence a "
                             "replica a microbatch")
        comm = RecordingComm(mesh.size, META,
                             spans_nodes=mesh.size > NODE_CARDS,
                             node_cards=NODE_CARDS)
        trainer = FSDPTrainer(arch, tcfg, opts, mesh, comm,
                              fsdp_over_pod=big)
        local, states = trainer.init(params)
        del params
        ax = 1 if accum > 1 else 0

        def step(lp, st, batch):
            new, st, metrics = trainer.step([lp], [st], {
                k: _global_view(v, nb, ax) for k, v in batch.items()})
            return new[0], st[0], metrics

        args = (local[0], states[0], local_rows)
        t = trainer.t
        layout = (f"FSDP over {'+'.join(_batch_axes(mesh))}"
                  + (f" x TP over model={t} (rank 0's model shard: "
                     f"{arch.n_heads // t} heads, "
                     f"{max(arch.n_kv_heads // t, 1)} kv heads)"
                     if t > 1 else "")
                  + f" ({mesh.size} ranks, rank 0)")
    notes = (f"accum={accum} mb={mb_global} opt={tcfg.opt.name} "
             f"{layout}")
    return Cell(arch, shape, opts, step, args, "train", comm, notes)


def _global_view(x: torch.Tensor, n: int, ax: int) -> torch.Tensor:
    """The rank's one row ``x`` (along ``ax``) seen as the global batch of
    ``n`` replicas: every row is the rank's (stride 0), so no byte is
    added."""
    size, stride = list(x.shape), list(x.stride())
    size[ax], stride[ax] = n, 0
    return x.as_strided(size, stride, x.storage_offset())


def _serve_batch(shape: ShapeConfig, mesh: Mesh) -> Tuple[int, str]:
    """Rows a replica serves: the batch split over the data axes where it
    divides them, else every row (replicated)."""
    nb = _replicas(mesh)
    b = shape.global_batch
    if b % nb == 0 and b >= nb:
        return b // nb, f"B={b} split over {nb} replicas"
    return b, f"B={b} replicated on {nb} replicas"


class _Serving:
    """A serving cell's weights and forward on ``mesh``: whole weights,
    or rank 0's shard of a tensor-parallel replica when the mesh has a
    ``"model"`` axis wider than 1 (module docstring)."""

    def __init__(self, arch: ArchConfig, opts: ModelOptions, mesh: Mesh):
        self.arch, self.opts = arch, opts
        self.t = mesh.shape.get("model", 1)
        params = abstract_params(arch, opts)
        self.held_whole = 0
        if self.t == 1:
            self.params, self.comm, self.cache_cfg = params, None, arch
            self.weights = "whole weights"
            return
        self.comm = RecordingComm(self.t, META,
                                  spans_nodes=self.t > NODE_CARDS)
        self.params = shard_params_tp(params, arch, mesh, shards=[0],
                                      device=META)[0]
        view = self.cache_cfg = shard_config(arch, self.t)
        what = (f"{view.n_heads} heads, "
                + ("MLA's latent whole" if arch.mla is not None
                   else f"{view.n_kv_heads} kv heads"))
        if arch.moe is not None:
            own = view.moe.experts_of(0)
            what += (f", experts {own.start}-{own.stop - 1} of "
                     f"{arch.moe.n_experts}")
        self.weights = f"TP over model={self.t} (rank 0's shard: {what})"
        specs = param_pspecs(params, mesh, mode="serve",
                             kv_heads_divide=arch.n_kv_heads % self.t == 0,
                             cfg=arch)
        self.held_whole = sum(
            x.numel() * x.element_size()
            for path, x in leaves_with_path(self.params)
            if "data" in get_path(specs, path))

    def last_logits(self, params, tokens, *, cache=None, **kw):
        """``forward``'s served position: ``(logits (B, V), cache)``."""
        if self.comm is None:
            logits, cache = forward(params, self.arch, tokens, cache=cache,
                                    opts=self.opts, **kw)
            return logits[:, -1], cache
        logits, caches = forward([params], self.arch, tokens,
                                 cache=None if cache is None else [cache],
                                 opts=self.opts, comm=self.comm, **kw)
        return (gather_vocab(self.comm, [logits[0][:, -1]],
                             self.arch.vocab)[0],
                None if caches is None else caches[0])


def build_prefill_cell(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh
                       ) -> Cell:
    opts = model_options(arch, shape)
    b, layout = _serve_batch(shape, mesh)
    serving = _Serving(arch, opts, mesh)
    tokens = torch.empty((b, shape.seq_len), dtype=torch.int32, device=META)
    extras = _extras(arch, (b,), shape.seq_len, "prefill")

    def step(params, tokens, extras):
        with torch.no_grad():      # serving returns last-position logits
            return serving.last_logits(params, tokens, mode="prefill",
                                       **extras)[0]

    return Cell(arch, shape, opts, step, (serving.params, tokens, extras),
                "prefill", serving.comm,
                f"{layout} T={shape.seq_len} {serving.weights}",
                serving.held_whole)


def build_decode_cell(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh
                      ) -> Cell:
    opts = model_options(arch, shape)
    b, layout = _serve_batch(shape, mesh)
    serving = _Serving(arch, opts, mesh)
    cache = abstract(init_cache, serving.cache_cfg, b, shape.cache_len, opts,
                     device="cpu")
    cache["pos"] = shape.cache_len - 1
    token = torch.empty((b, 1), dtype=torch.int32, device=META)
    extras = _extras(arch, (b,), 1, "decode")

    def step(params, token, cache, extras):
        with torch.no_grad():
            return serving.last_logits(params, token, cache=cache,
                                       mode="decode", **extras)

    return Cell(arch, shape, opts, step,
                (serving.params, token, cache, extras), "decode",
                serving.comm, f"{layout} C={shape.cache_len} readonly "
                f"{serving.weights}", serving.held_whole)


def build_cell(arch: ArchConfig, shape_name: str, mesh: Mesh) -> Cell:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(arch, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_cell(arch, shape, mesh)
    return build_decode_cell(arch, shape, mesh)
