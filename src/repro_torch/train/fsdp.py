"""The train step over a mesh: fully sharded data parallelism (FSDP,
ZeRO-3) over ``"data"``, the layout the JAX package's training launcher
asks of XLA (``param_shardings(params, mesh)`` on its host mesh, the
batch split over the data axis).

Each shard holds its part of every leaf that
``distributed.sharding.param_pspecs`` splits (``mode="train"``), and the
optimizer state inherits the parameters' layout (AdamW's ``mu``, ``nu``
and float32 ``master`` are the shard's parts). A step, on every shard:

1. gathers the parameters (``all_gather`` of every shard's part);
2. runs forward and backward on its contiguous part of the batch rows,
   its summed token loss divided by the global count of unmasked labels
   (summed across shards first: a mean of per-shard means is wrong
   whenever the shards' counts differ), so the shards' gradients sum to
   the global batch's;
3. reduces the gradients across shards in shard order, in float32: each
   shard gets the sum of its own part (``psum_scatter``);
4. clips by the global norm (each shard's part's sum of squares, summed
   in shard order) and updates its own part.

Adafactor's factored statistics need a leaf's full rows and columns, so
under Adafactor the gradients are reduced in full (``psum``) on every
shard, its state is kept whole on every shard, and each shard applies the
update to its own part of the parameters.

The shards are ``comm.shards``: every shard in one process over a
``LocalComm`` (several simulated on one device, or one a card), or this
process's rank over a ``GroupComm``; both give the same bits. Every mesh
axis but ``"pod"`` and ``"data"`` must have extent 1 (the port runs no
tensor parallelism; a shard runs its rows' whole computation).
Checkpoints hold the full leaves, so a run restores onto any shard count
(:meth:`FSDPTrainer.restore`, the JAX package's elastic restore).
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.mesh import Mesh, comm_for
from ..distributed.sharding import local_slices, param_pspecs, shard_tree
from ..models import ModelOptions
from ..tree import leaves_with_path, tree_map, tree_map_with_path
from . import checkpoint
from .optimizer import (adafactor_init, adafactor_update, adamw_init,
                        adamw_update, clip_from_norm, layer_stacks)
from .train_step import TrainConfig, loss_and_grads

__all__ = ["FSDPTrainer"]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


class FSDPTrainer:
    """FSDP training of ``cfg`` over ``mesh`` (module docstring). ``comm``
    defaults to the mesh's ``LocalComm``; a ``GroupComm`` runs this
    process's rank."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig,
                 opts: ModelOptions, mesh: Mesh, comm=None, *,
                 fsdp_over_pod: bool = False):
        others = {a: n for a, n in mesh.shape.items()
                  if a not in ("pod", "data") and n != 1}
        if others:
            raise ValueError(f"the sharded step runs FSDP over the data "
                             f"axis; mesh axes {others} would need tensor "
                             f"parallelism, which is not ported")
        if tcfg.opt.name not in ("adamw", "adafactor"):
            raise ValueError(tcfg.opt.name)
        self.cfg, self.tcfg, self.opts, self.mesh = cfg, tcfg, opts, mesh
        self.comm = comm_for(mesh) if comm is None else comm
        if self.comm.n != mesh.size:
            raise ValueError(f"a comm of {self.comm.n} shards for a mesh of "
                             f"{mesh.size}")
        self.fsdp_over_pod = fsdp_over_pod
        self.stacks = layer_stacks(cfg)
        self.specs = None

    # ---- layout ---------------------------------------------------------
    @property
    def shards(self) -> List[int]:
        return list(self.comm.shards)

    def _specs_for(self, params):
        if self.specs is None:
            self.specs = param_pspecs(params, self.mesh, mode="train",
                                      fsdp_over_pod=self.fsdp_over_pod,
                                      cfg=self.cfg)
        return self.specs

    def _cut(self, x: torch.Tensor, spec, j: int) -> torch.Tensor:
        return x[local_slices(x.shape, spec, self.mesh, j)]

    def shard(self, tree, specs=None) -> list:
        """Each of this process's shards' parts of a full tree (contiguous
        copies on the shard's device), placed as ``specs`` (the
        parameters' by default)."""
        specs = self.specs if specs is None else specs
        return [shard_tree(tree, specs, self.mesh, j, self.comm.device(j))
                for j in self.shards]

    def gather(self, local: list, specs=None, *, first: bool = False
               ) -> list:
        """The full tree on each of this process's shards (with
        ``first``, on its first shard only), from every shard's parts
        (``all_gather``; where this process holds every shard, its parts
        are read directly)."""
        specs = self.specs if specs is None else specs
        n = self.comm.n
        ks = [0] if first else list(range(len(self.shards)))
        full = [[] for _ in ks]
        items = [dict(leaves_with_path(t)) for t in local]
        for path in items[0]:
            spec = _spec_at(specs, path)
            if len(items) == n:         # every shard in this process
                parts = [torch.stack([it[path].to(
                    self.comm.device(self.shards[k])) for it in items])
                    for k in ks]
            else:
                parts = self.comm.all_gather([it[path] for it in items])
            for k, stacked in enumerate(parts):
                shape = _full_shape(stacked.shape[1:], spec, self.mesh)
                x = torch.empty(shape, dtype=stacked.dtype,
                                device=stacked.device)
                for t in range(n):
                    x[local_slices(shape, spec, self.mesh, t)] = stacked[t]
                full[k].append(x)
            del parts
        return [_rebuild(local[k], full[k]) for k in range(len(ks))]

    def state_specs(self, states) -> Any:
        """Placements of an optimizer state: AdamW's moments and master as
        the parameters, its step whole; Adafactor's state whole."""
        if self.tcfg.opt.name == "adamw":
            return {"mu": self.specs, "nu": self.specs,
                    "master": self.specs, "step": ()}
        return tree_map(lambda x: (None,) * x.dim(), states)

    # ---- init, bytes ----------------------------------------------------
    def init(self, params) -> Tuple[list, list]:
        """``(local params, local optimizer states)`` of this process's
        shards from the full parameters (the same tree on every
        process)."""
        self._specs_for(params)
        local = self.shard(params)
        if self.tcfg.opt.name == "adamw":
            states = [adamw_init(lp) for lp in local]
        else:
            states = [adafactor_init(tree_map(
                lambda x, j=j: x.to(self.comm.device(j)), params),
                self.stacks) for j in self.shards]
        return local, states

    def place(self, params, opt) -> Tuple[list, list]:
        """Each of this process's shards' parts of whole parameters and a
        whole optimizer state (a checkpoint's leaves, or another shard
        count's gathered ones), cut as :meth:`restore` cuts them."""
        self._specs_for(params)
        return self.shard(params), self.shard(opt, self.state_specs(opt))

    @staticmethod
    def resident_bytes(local, states) -> List[Tuple[int, int]]:
        """(parameter bytes, optimizer-state bytes) each shard holds."""
        def nbytes(tree):
            return sum(x.numel() * x.element_size()
                       for _, x in leaves_with_path(tree))
        return [(nbytes(p), nbytes(s)) for p, s in zip(local, states)]

    # ---- the step -------------------------------------------------------
    def _rows(self, batch, k: int):
        """Shard ``self.shards[k]``'s contiguous part of the batch rows,
        on its device."""
        n, j = self.comm.n, self.shards[k]
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} shards")
        per = rows // n
        dev = self.comm.device(j)
        return {key: torch.as_tensor(v)[j * per:(j + 1) * per].to(dev)
                for key, v in batch.items()}

    def _grads(self, full: list, batch):
        """Per shard of this process: (its loss share, its gradients) of
        one microbatch."""
        rows = [self._rows(batch, k) for k in range(len(self.shards))]
        counts = self.comm.psum([(r["labels"] >= 0).sum().to(torch.float32)
                                 for r in rows])
        out = []
        for k, r in enumerate(rows):
            denom = torch.clamp(counts[k], min=1.0)
            out.append(loss_and_grads(full[k], self.cfg, r, self.opts,
                                      self.tcfg.z_loss, denom))
        return out

    def step(self, local: list, states: list, batch) -> Tuple[list, list,
                                                              dict]:
        """One optimizer step on the global ``batch`` (every shard is
        given the same one; ``tokens`` (B, T), or (accum, B, T) with
        ``tcfg.accum`` > 1). Returns (local params, local states, metrics
        of this process's first shard)."""
        tcfg = self.tcfg
        full = self.gather(local)
        if tcfg.accum == 1:
            res = self._grads(full, batch)
            losses = [r[0] for r in res]
            grads = [r[1] for r in res]
        else:
            grads, losses = None, None
            for i in range(tcfg.accum):
                res = self._grads(full, {k: v[i] for k, v in batch.items()})
                if grads is None:
                    grads = [tree_map(lambda g: g.to(tcfg.accum_dtype), r[1])
                             for r in res]
                    losses = [r[0] for r in res]
                else:
                    for acc, r in zip(grads, res):
                        tree_map(lambda a, g: a.add_(g.to(tcfg.accum_dtype)),
                                 acc, r[1])
                    losses = [a + r[0] for a, r in zip(losses, res)]
                del res
        del full
        loss = self.comm.psum(losses)
        if tcfg.accum > 1:
            loss = [x / tcfg.accum for x in loss]
        full_grads = tcfg.opt.name == "adafactor"
        red = self._reduce(grads, full_grads)
        del grads
        if tcfg.accum > 1:
            red = [tree_map(lambda g: g / tcfg.accum, t) for t in red]
        clips = self._clip(red, full_grads)
        new_local, om = [], None
        for k, j in enumerate(self.shards):
            if tcfg.opt.name == "adamw":
                p, states[k], m = adamw_update(red[k], states[k], local[k],
                                               tcfg.opt, clip=clips[k])
            else:
                p, states[k], m = adafactor_update(
                    red[k], states[k], local[k], tcfg.opt, self.stacks,
                    clip=clips[k],
                    local=lambda path, u, j=j: self._cut(
                        u, _spec_at(self.specs, path), j))
            new_local.append(p)
            om = om or m
        return new_local, states, {"loss": loss[0], **om}

    def _reduce(self, grads: list, full: bool) -> list:
        """The gradients summed across shards in shard order, in float32:
        each shard's own parts (``psum_scatter``), or with ``full`` every
        leaf whole (``psum``)."""
        n = self.comm.n
        items = [dict(leaves_with_path(g)) for g in grads]
        out = [[] for _ in self.shards]
        for path in list(items[0]):
            spec = _spec_at(self.specs, path)
            if full or all(a is None for a in spec):
                red = self.comm.psum([it[path].to(torch.float32)
                                      for it in items])
            else:
                shape = items[0][path].shape
                red = self.comm.psum_scatter([[
                    it[path][local_slices(shape, spec, self.mesh, t)].to(
                        torch.float32) for t in range(n)] for it in items])
            for k, r in enumerate(red):
                out[k].append(r)
        return [_rebuild(g, out[k]) for k, g in enumerate(grads)]

    def _owner(self, spec, j: int) -> bool:
        """Whether shard j holds the first copy of its part of a leaf
        placed as ``spec`` (the part's sum of squares counts once)."""
        used = set()
        for entry in spec:
            if entry is not None:
                used.update((entry,) if isinstance(entry, str) else entry)
        at = self.mesh.coords(j)
        return all(at[a] == 0 for a in self.mesh.axis_names if a not in used)

    def _clip(self, red: list, full: bool) -> list:
        """(clip factor, global norm) per shard of this process."""
        sums = []
        for k, j in enumerate(self.shards):
            total = torch.zeros((), dtype=torch.float32,
                                device=self.comm.device(j))
            for path, g in leaves_with_path(red[k]):
                # whole leaves (Adafactor) count on shard 0 alone
                if (j == 0 if full
                        else self._owner(_spec_at(self.specs, path), j)):
                    total = total + torch.sum(torch.square(g))
            sums.append(total)
        sums = self.comm.psum(sums)
        return [clip_from_norm(torch.sqrt(s), self.tcfg.opt.grad_clip)
                for s in sums]

    # ---- checkpoints ----------------------------------------------------
    def save(self, directory: str, step: int, local: list,
             states: list) -> None:
        """The full parameters and optimizer state, written once (by the
        process holding shard 0) in the single-device layout."""
        params = self.gather(local, first=True)[0]
        if self.tcfg.opt.name == "adamw":
            opt = self.gather(states, self.state_specs(states),
                              first=True)[0]
        else:
            opt = states[0]
        if 0 in self.shards:
            checkpoint.save(directory, step, {"params": params, "opt": opt})
        # every process returns once the checkpoint is complete
        self.comm.psum([torch.zeros((), device=self.comm.device(j))
                        for j in self.shards])

    def restore(self, directory: str, local: list, states: list,
                step: Optional[int] = None) -> Tuple[list, list, int]:
        """A checkpoint of any shard count (or a single-device one) onto
        this trainer's shards: each shard reads its parts of the full
        leaves. ``local`` and ``states`` give the shards' structure."""
        sspecs = self.state_specs(states[0])
        out_p, out_s, at = [], [], 0
        for k, j in enumerate(self.shards):
            target = {"params": local[k], "opt": states[k]}
            cuts = tree_map_with_path(
                lambda path, _, j=j: self._cutter(path, sspecs, j), target)
            got, at = checkpoint.restore(directory, target, step,
                                         shardings=cuts)
            out_p.append(got["params"])
            out_s.append(got["opt"])
        return out_p, out_s, at

    def _cutter(self, path, sspecs, j):
        specs = self.specs if path[0] == "params" else sspecs
        spec = _spec_at(specs, path[1:])
        return lambda x: self._cut(x, spec, j)


def _rebuild(tree, flat: list):
    """``tree``'s structure with ``flat``'s tensors as its leaves."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def _spec_at(specs, path: Sequence) -> tuple:
    node = specs
    for key in path:
        if _is_spec(node):
            break
        node = node[key]
    return node


def _full_shape(part_shape, spec, mesh: Mesh) -> tuple:
    out = []
    for dim, entry in zip(part_shape, spec):
        if entry is None:
            out.append(dim)
        else:
            entry = (entry,) if isinstance(entry, str) else entry
            out.append(dim * math.prod(mesh.shape[a] for a in entry))
    return tuple(out)
