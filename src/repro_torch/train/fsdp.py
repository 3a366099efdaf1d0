"""The train step over a mesh: fully sharded data parallelism (FSDP,
ZeRO-3) over ``"data"``, the layout the JAX package's training launcher
asks of XLA (``param_shardings(params, mesh)`` on its host mesh, the
batch split over the data axis), and, on a ``("data", "model")`` mesh
whose model axis is wider than 1, FSDP × tensor parallelism — the layout
``param_pspecs(mode="train")`` gives the JAX package on its production
mesh, where GSPMD places heads, the FFN width and the vocabulary on
``"model"``.

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

**Over a model axis** (``t`` > 1, the dense decoders that
``tensor_parallel.tp_degree(mode="train")`` splits; MoE and MLA, which
serving splits, raise: their gradients over ``"model"`` are ROADMAP
A10e): a data replica is ``t`` model
shards, each cut at head boundaries as ``tensor_parallel.shard_params_tp``
cuts them for serving (:func:`tensor_parallel.tp_slices`), and each model
shard's parts are cut again over the data axes on the dims the train
layout marks ``fsdp``. The groups: a *replica* is the ``t`` shards of one
data coordinate, a *data group* the shards of one model coordinate
across the batch axes. A step, on each shard:

1. gathers its model shard's tree over its data group only;
2. runs forward and backward over its replica's model comm
   (``models.forward(comm=)``; the psums' conjugate pair,
   ``distributed.mesh.psum_fwd`` / ``psum_bwd``), with the
   vocab-parallel loss (``train_step.cross_entropy_terms_tp``: the
   ``(B, T, V)`` logits are never gathered), the replica's rows the same
   on its ``t`` shards, the label count summed over the data group;
3. reduce-scatters the gradients (``psum_scatter``) over its data group
   only; a leaf whose holders' gradients are partial
   (``tensor_parallel.tp_partial``: qwen3's q / k norms, a kv head on
   several shards) is then summed over exactly its holders
   (``tp_holders``), the rest are whole;
4. clips by the global norm, each part counted once over both axes (a
   part held by several model shards on the first of them), and updates
   its own part with AdamW.

Adafactor's factored statistics need a leaf's full rows and columns, so
under Adafactor the gradients are reduced in full (``psum``) on every
shard, its state is kept whole on every shard, and each shard applies the
update to its own part of the parameters. It runs over the data axes
only: with a model axis wider than 1 it raises (ROADMAP A10e; the one
arch that trains with it, arctic-480b, has experts that training does
not split over ``"model"`` yet).

The shards are ``comm.shards``: every shard in one process over a
``LocalComm`` (several simulated on one device, or one a card), or this
process's rank over a ``GroupComm``; both give the same bits. Mesh axes
other than ``"pod"``, ``"data"`` and ``"model"`` must have extent 1. On
a mesh without a model axis wider than 1 the step is the data-parallel
one above, bit for bit. Checkpoints hold the full leaves (the
single-device layout), so a run restores onto any mesh: one device,
``(n, 1)`` or ``(d, t)`` (:meth:`FSDPTrainer.restore`, the JAX
package's elastic restore).
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.mesh import Mesh, comm_for
from ..distributed.sharding import local_slices, param_pspecs
from ..distributed.tensor_parallel import (shard_config, tp_holders,
                                           tp_partial, tp_slices)
from ..models import ModelOptions
from ..tree import leaves_with_path, tree_map, tree_map_with_path
from . import checkpoint
from .optimizer import (adafactor_init, adafactor_update, adamw_init,
                        adamw_update, clip_from_norm, layer_stacks)
from .train_step import TrainConfig, loss_and_grads, loss_and_grads_tp

__all__ = ["FSDPTrainer"]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


class FSDPTrainer:
    """FSDP training of ``cfg`` over ``mesh``, and FSDP × tensor
    parallelism where its ``"model"`` axis is wider than 1 (module
    docstring). ``comm`` defaults to the mesh's ``LocalComm``; a
    ``GroupComm`` (its ranks the mesh's shards) runs this process's
    rank."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig,
                 opts: ModelOptions, mesh: Mesh, comm=None, *,
                 fsdp_over_pod: bool = False):
        others = {a: n for a, n in mesh.shape.items()
                  if a not in ("pod", "data", "model") and n != 1}
        if others:
            raise ValueError(f"the sharded step runs over the 'pod', "
                             f"'data' and 'model' axes; mesh axes {others} "
                             f"have no place in it")
        if tcfg.opt.name not in ("adamw", "adafactor"):
            raise ValueError(tcfg.opt.name)
        self.t = mesh.shape.get("model", 1)
        if self.t > 1:
            shard_config(cfg, self.t, "train")  # raises unless t splits
            if tcfg.opt.name == "adafactor":
                raise ValueError(
                    f"Adafactor over a model axis of {self.t}: its factored "
                    f"state needs whole leaves, and the arch that trains "
                    f"with it (arctic-480b) is not split over 'model' for "
                    f"training yet (ROADMAP A10e); use AdamW or a model "
                    f"axis of 1")
        self.cfg, self.tcfg, self.opts, self.mesh = cfg, tcfg, opts, mesh
        self.comm = comm_for(mesh) if comm is None else comm
        if self.comm.n != mesh.size:
            raise ValueError(f"a comm of {self.comm.n} shards for a mesh of "
                             f"{mesh.size}")
        self.fsdp_over_pod = fsdp_over_pod
        self.stacks = layer_stacks(cfg)
        self.specs = None
        self._pos = {j: k for k, j in enumerate(self.comm.shards)}
        batch_axes = tuple(a for a in mesh.axis_names if a != "model")
        # a data group: one model coordinate across the batch axes; a
        # replica: the t model shards of one data coordinate
        self._dgroups = self._split(mesh.groups(batch_axes))
        self.replicas = (mesh.groups(("model",)) if "model" in mesh.shape
                         else [[j] for j in range(mesh.size)])
        self._rgroups = (self._split(self.replicas) if self.t > 1 else [])
        self._replica_of = {j: r for r, g in enumerate(self.replicas)
                            for j in g}

    def _split(self, groups) -> list:
        """``(members, comm)`` of each group holding one of this process's
        shards: the comm itself for one group of every shard."""
        if len(groups) == 1 and len(groups[0]) == self.comm.n:
            return [(list(groups[0]), self.comm)]
        return [(members, c) for members, c in self.comm.split(groups)]

    def _mine(self, members) -> List[int]:
        """This process's positions (into ``self.shards``) of the
        ``members`` it holds, in the members' order."""
        return [self._pos[j] for j in members if j in self._pos]

    # ---- layout ---------------------------------------------------------
    @property
    def shards(self) -> List[int]:
        return list(self.comm.shards)

    def _model_coord(self, j: int) -> int:
        return self.mesh.coords(j).get("model", 0)

    def _specs_for(self, params):
        if self.specs is None:
            self.specs = param_pspecs(
                params, self.mesh, mode="train",
                kv_heads_divide=self.cfg.n_kv_heads % self.t == 0,
                fsdp_over_pod=self.fsdp_over_pod, cfg=self.cfg)
        return self.specs

    def _dspec(self, spec) -> tuple:
        """A leaf's placement over the data axes alone: its cut within a
        model shard's part (``spec`` itself without a model axis)."""
        if self.t == 1:
            return spec
        return tuple(None if e == "model" else e for e in spec)

    def _part(self, x: torch.Tensor, path, spec, j: int) -> torch.Tensor:
        """Shard ``j``'s part of the whole leaf ``x`` at ``path``: its
        model shard's part, cut over the data axes."""
        if self.t > 1:
            x = x[tp_slices(x.shape, path, spec, self.cfg, self.t,
                            self._model_coord(j))]
        return x[local_slices(x.shape, self._dspec(spec), self.mesh, j)]

    def shard(self, tree, specs=None) -> list:
        """Each of this process's shards' parts of a full tree (contiguous
        copies on the shard's device), placed as ``specs`` (the
        parameters' by default)."""
        specs = self.specs if specs is None else specs
        return [tree_map_with_path(
            lambda path, x, j=j: self._part(
                x, path, _spec_at(specs, path), j).to(
                self.comm.device(j), copy=True).contiguous(), tree)
            for j in self.shards]

    def gather(self, local: list, specs=None) -> list:
        """Each of this process's shards' model shard's tree (the full
        tree where the model axis is 1), from the parts of its data group
        (``all_gather``; where this process holds the whole group, its
        parts are read directly)."""
        return self._gather(local, specs, range(len(self.shards)))

    def _gather(self, local: list, specs, ks: Sequence[int]) -> list:
        specs = self.specs if specs is None else specs
        full = {k: [] for k in ks}
        items = [dict(leaves_with_path(t)) for t in local]
        for path in items[0]:
            dspec = self._dspec(_spec_at(specs, path))
            for members, comm in self._dgroups:
                mine = self._mine(members)
                want = [k for k in ks if self.shards[k] in members]
                if not want:
                    continue
                if len(mine) == len(members):   # the group in this process
                    parts = [torch.stack([items[i][path].to(
                        self.comm.device(self.shards[k])) for i in mine])
                        for k in want]
                else:
                    parts = comm.all_gather([items[i][path] for i in mine])
                    parts = [parts[mine.index(k)] for k in want]
                for k, stacked in zip(want, parts):
                    shape = _full_shape(stacked.shape[1:], dspec, self.mesh)
                    x = torch.empty(shape, dtype=stacked.dtype,
                                    device=stacked.device)
                    for i, t in enumerate(members):
                        x[local_slices(shape, dspec, self.mesh, t)] = \
                            stacked[i]
                    full[k].append(x)
                del parts
        return [_rebuild(local[k], full[k]) for k in ks]

    def whole(self, local: list, specs=None) -> Any:
        """The full tree (the single-device layout) on this process's
        first shard's device, from every shard's parts (over a model axis,
        each model shard's tree gathered over its data group and the ``t``
        trees joined; every process must call it)."""
        specs = self.specs if specs is None else specs
        if self.t == 1:
            return self._gather(local, specs, [0])[0]
        members, rcomm = next((g, c) for g, c in self._rgroups
                              if self.shards[0] in g)
        mine = self._mine(members)
        trees = self._gather(local, specs, mine)
        dev = self.comm.device(self.shards[0])
        items = [dict(leaves_with_path(t)) for t in trees]
        out = []
        for path in items[0]:
            spec = _spec_at(specs, path)
            if len(mine) == len(members):
                parts = [it[path].to(dev) for it in items]
            else:
                parts = list(rcomm.all_gather([it[path] for it in items])[0]
                             .unbind(0))
            out.append(self._join(path, spec, parts))
        return _rebuild(local[0], out)

    def _join(self, path, spec, parts: list) -> torch.Tensor:
        """A whole leaf from its ``t`` model shards' parts (the inverse of
        ``tp_slices``)."""
        for d, entry in enumerate(spec):
            if entry == "model":
                return torch.cat(parts, d)
        holders = tp_holders(path, spec, self.cfg, self.t)
        if len(holders) > 1:          # a kv head on each group of holders
            return torch.cat([parts[g[0]] for g in holders], -1)
        return parts[0]

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
        """Shard ``self.shards[k]``'s replica's contiguous part of the
        batch rows, on its device."""
        j = self.shards[k]
        n, r = len(self.replicas), self._replica_of[j]
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} data replicas")
        per = rows // n
        dev = self.comm.device(j)
        return {key: torch.as_tensor(v)[r * per:(r + 1) * per].to(dev)
                for key, v in batch.items()}

    def _data_psum(self, vals: list) -> list:
        """Per shard of this process, the sum of ``vals`` (one a shard)
        over its data group."""
        out = [None] * len(vals)
        for members, comm in self._dgroups:
            mine = self._mine(members)
            for i, r in zip(mine, comm.psum([vals[i] for i in mine])):
                out[i] = r
        return out

    def _grads(self, full: list, batch):
        """Per shard of this process: (its loss share, its gradients) of
        one microbatch."""
        rows = [self._rows(batch, k) for k in range(len(self.shards))]
        counts = self._data_psum([(r["labels"] >= 0).sum().to(torch.float32)
                                  for r in rows])
        denoms = [torch.clamp(c, min=1.0) for c in counts]
        if self.t == 1:
            return [loss_and_grads(full[k], self.cfg, r, self.opts,
                                   self.tcfg.z_loss, denoms[k])
                    for k, r in enumerate(rows)]
        out = [None] * len(rows)
        for members, rcomm in self._rgroups:
            mine = self._mine(members)
            res = loss_and_grads_tp(
                [full[i] for i in mine], self.cfg, [rows[i] for i in mine],
                self.opts, rcomm, self.tcfg.z_loss, [denoms[i] for i in mine])
            for i, r in zip(mine, res):
                out[i] = r
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
        loss = self._data_psum(losses)
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
                    local=lambda path, u, j=j: self._part(
                        u, path, _spec_at(self.specs, path), j))
            new_local.append(p)
            om = om or m
        return new_local, states, {"loss": loss[0], **om}

    def _reduce(self, grads: list, full: bool) -> list:
        """The gradients summed across each data group in shard order, in
        float32: each shard's own parts (``psum_scatter``), or with
        ``full`` every leaf whole (``psum``); then a leaf whose holders'
        gradients are partial summed over its holders (module
        docstring)."""
        items = [dict(leaves_with_path(g)) for g in grads]
        out = [[] for _ in self.shards]
        for path in list(items[0]):
            spec = _spec_at(self.specs, path)
            dspec = self._dspec(spec)
            red = [None] * len(self.shards)
            for members, comm in self._dgroups:
                mine = self._mine(members)
                if full or all(a is None for a in dspec):
                    got = comm.psum([items[i][path].to(torch.float32)
                                     for i in mine])
                else:
                    shape = items[mine[0]][path].shape
                    got = comm.psum_scatter([[
                        items[i][path][local_slices(shape, dspec, self.mesh,
                                                    t)].to(torch.float32)
                        for t in members] for i in mine])
                for i, r in zip(mine, got):
                    red[i] = r
            if self.t > 1 and tp_partial(path, self.cfg, self.t):
                red = self._holder_sum(path, spec, red)
            for k, r in enumerate(red):
                out[k].append(r)
        return [_rebuild(g, out[k]) for k, g in enumerate(grads)]

    def _holder_sum(self, path, spec, vals: list) -> list:
        """Each shard's ``vals`` summed over the model shards of its
        replica that hold the same part (``tp_holders``), in model
        order: a psum over the replica where every shard holds it, else
        an all-gather over the replica folded over the holders."""
        holders = tp_holders(path, spec, self.cfg, self.t)
        out = list(vals)
        for members, rcomm in self._rgroups:
            mine = self._mine(members)
            xs = [vals[i] for i in mine]
            if len(holders) == 1:
                got = rcomm.psum(xs)
            else:
                got = []
                for i, stacked in zip(mine, rcomm.all_gather(xs)):
                    m = self._model_coord(self.shards[i])
                    group = next(g for g in holders if m in g)
                    acc = stacked[group[0]]
                    for h in group[1:]:
                        acc = acc + stacked[h]
                    got.append(acc)
            for i, r in zip(mine, got):
                out[i] = r
        return out

    def _owner(self, path, spec, j: int) -> bool:
        """Whether shard j holds the first copy of its part of the leaf at
        ``path`` placed as ``spec`` (the part's sum of squares counts
        once): the first along every batch axis that does not cut it,
        and the first of the model shards that hold the same part."""
        used = set()
        for entry in self._dspec(spec):
            if entry is not None:
                used.update((entry,) if isinstance(entry, str) else entry)
        at = self.mesh.coords(j)
        m = at.get("model", 0)
        first = next(g[0] for g in tp_holders(path, spec, self.cfg, self.t)
                     if m in g)
        return m == first and all(at[a] == 0 for a in self.mesh.axis_names
                                  if a != "model" and a not in used)

    def _clip(self, red: list, full: bool) -> list:
        """(clip factor, global norm) per shard of this process."""
        sums = []
        for k, j in enumerate(self.shards):
            total = torch.zeros((), dtype=torch.float32,
                                device=self.comm.device(j))
            for path, g in leaves_with_path(red[k]):
                # whole leaves (Adafactor) count on shard 0 alone
                if (j == 0 if full
                        else self._owner(path, _spec_at(self.specs, path),
                                         j)):
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
        params = self.whole(local)
        if self.tcfg.opt.name == "adamw":
            opt = self.whole(states, self.state_specs(states))
        else:
            opt = states[0]
        if 0 in self.shards:
            checkpoint.save(directory, step, {"params": params, "opt": opt})
        # every process returns once the checkpoint is complete
        self.comm.psum([torch.zeros((), device=self.comm.device(j))
                        for j in self.shards])

    def restore(self, directory: str, local: list, states: list,
                step: Optional[int] = None) -> Tuple[list, list, int]:
        """A checkpoint of any mesh (or a single-device one) onto this
        trainer's shards: each shard reads its parts of the full leaves.
        ``local`` and ``states`` give the shards' structure."""
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
        return lambda x: self._part(x, path[1:], spec, j)


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
