"""A device mesh and its collectives — the port's counterpart of the JAX
package's ``Mesh`` + ``shard_map`` collectives (``all_gather``,
``all_to_all``, ``psum``, ``pmin``, ``pmax``).

The JAX package runs one program over a mesh (single-controller SPMD).
The port keeps that shape with plain functions on tensors:

* :class:`Mesh` — a grid of ``torch.device``\\ s with one to three named
  axes (the LM's layouts name ``("pod", "data", "model")``). :func:`make_mesh` takes the present cards by default and raises
  when more shards are asked for than there are cards. Several shards
  on one device (on one card, or on the CPU in the tests) come only from
  an explicit list such as ``devices=["cuda:0"] * 4`` — the counterpart
  of the JAX package's forced host device count; nothing puts N shards
  on one device quietly.
* :class:`LocalComm` — the collectives in one process over per-shard
  tensor lists: shard j's value lives on the mesh's j-th device, and
  every copy goes device to device (no host round trip).
* :class:`GroupComm` — the same collectives over a ``torch.distributed``
  process group, one shard a process (gloo on the CPU; NCCL across
  cards is the same calls, untested on a one-card host).
* ``comm.axis(name)`` — the comm along one mesh axis: over the shards
  that share every other coordinate (the model shards of one data
  replica, for tensor parallelism), in their order along the axis;
  ``comm.split(groups)`` — a comm over each group of shards that holds
  one of this process's (every group in one process, this rank's over a
  process group): the 2-D train step's data groups (the shards of one
  model shard across the batch axes) and its replicas.
* :func:`psum_fwd` and :func:`psum_bwd` — Megatron's conjugate pair for
  tensor parallelism under autograd: a psum whose backward is the
  identity (after a shard's partial output: o, down, the loss's sums),
  and an identity whose backward is a psum (where the replicated
  activation enters a shard's column-cut projections). Each shard runs
  backward from its own copy of the loss; in one process the copies'
  backward passes run together (``torch.autograd.grad`` of every
  shard's loss) and give each shard the gradients a process of its own
  would get, to the bit.

A body written against a comm loops over ``comm.shards`` — every shard
in one process, or this process's rank — and hands the comm lists of
per-shard values in that order. Every reduction folds the shards in
shard order on every receiver, so both comms give the same bits.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "LocalComm", "GroupComm", "comm_for",
           "psum_fwd", "psum_bwd"]

Device = Union[str, torch.device]


class Mesh:
    """A grid of devices with named axes (row-major ``devices``)."""

    def __init__(self, devices: Sequence[Device], shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape = tuple(int(x) for x in shape)
        names = tuple(str(x) for x in axis_names)
        if len(shape) != len(names) or not 1 <= len(shape) <= 3 \
                or len(set(names)) != len(names):
            raise ValueError(f"a mesh has 1 to 3 distinct named axes, got "
                             f"shape {shape} and names {names}")
        if any(x < 1 for x in shape):
            raise ValueError(f"mesh extents must be >= 1, got {shape}")
        devs = [resolve_device(d) for d in devices]
        if len(devs) != math.prod(shape):
            raise ValueError(f"{len(devs)} devices for a mesh of shape "
                             f"{shape}")
        self.devices: List[torch.device] = devs
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    def flat(self, name: str = "shard") -> "Mesh":
        """The same devices as a 1-D mesh along ``name``."""
        return Mesh(self.devices, (self.size,), (name,))

    def coords(self, j: int) -> dict:
        """Shard ``j``'s index along each axis (row-major devices)."""
        out = {}
        for name in reversed(self.axis_names):
            j, out[name] = divmod(j, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def axis_groups(self, name: str) -> List[List[int]]:
        """The shards along axis ``name``: one list for each setting of
        the other coordinates (in row-major order of those), each list in
        the order of ``name``'s coordinate."""
        return self.groups((name,))

    def groups(self, over: Sequence[str]) -> List[List[int]]:
        """The shards that share every coordinate outside the axes
        ``over``: one list for each setting of the other coordinates (in
        row-major order of those), each in row-major order over ``over``
        (ascending shard index)."""
        for name in over:
            if name not in self.shape:
                raise ValueError(f"no axis {name!r} in mesh axes "
                                 f"{self.axis_names}")
        groups: dict = {}
        for j in range(self.size):
            at = self.coords(j)
            key = tuple(at[a] for a in self.axis_names if a not in over)
            groups.setdefault(key, []).append(j)
        return list(groups.values())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major). Without
    ``devices`` it takes the present cards, and raises when the mesh
    needs more than there are; simulated shards need the explicit list
    (``devices=["cuda:0"] * 4``, or ``["cpu"] * 4``)."""
    need = math.prod(int(x) for x in shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"make_mesh takes the present cards and no CUDA device is "
                f"available; for shards on the CPU pass "
                f"devices=['cpu'] * {need} (device='cpu' for every shard)")
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(
                f"a mesh of {need} shards exceeds the {have} visible "
                f"card(s); for simulated shards pass an explicit device "
                f"list, e.g. devices=['cuda:0'] * {need}")
        devices = [torch.device("cuda", j) for j in range(need)]
    return Mesh(list(devices), shape, names)


def _fold(vals, op):
    out = vals[0]
    for v in vals[1:]:
        out = op(out, v)
    return out


_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


class LocalComm:
    """The collectives over one process's per-shard lists: entry j of
    every list is shard j's value, on ``mesh.devices[j]``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.size
        self.shards = list(range(self.n))
        self.devices = list(mesh.devices)

    def device(self, j: int) -> torch.device:
        return self.mesh.devices[j]

    def axis(self, name: str) -> "LocalComm":
        """The comm along ``name``: a :class:`LocalComm` over the mesh's
        shards in their order along ``name``. The other axes must have
        extent 1 (one group: a process that holds several groups drives
        each over its own mesh)."""
        groups = self.mesh.axis_groups(name)
        if len(groups) != 1:
            raise ValueError(
                f"LocalComm.axis({name!r}) on a mesh of shape "
                f"{self.mesh.shape}: {len(groups)} groups along {name!r}, "
                f"one comm needs the other axes at extent 1")
        return LocalComm(Mesh(self.mesh.devices, (self.n,), (name,)))

    def split(self, groups: Sequence[Sequence[int]]
              ) -> List[Tuple[List[int], "LocalComm"]]:
        """``(members, comm)`` for every group of shards in ``groups``
        (lists of this comm's shard indices): a :class:`LocalComm` over
        the members' devices, in the members' order."""
        return [(list(g), LocalComm(Mesh([self.devices[j] for j in g],
                                         (len(g),), ("group",))))
                for g in groups]

    def _check(self, xs):
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} values for {self.n} shards")

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard gets ``stack(xs)`` (a new leading shard axis)."""
        self._check(xs)
        return [torch.stack([x.to(d, non_blocking=True) for x in xs])
                for d in self.devices]

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``xs[i]`` is (n, ...) — slice j goes to shard j; shard j gets
        (n, ...) with slice i from shard i (split and concat on the
        leading axis, tiled)."""
        self._check(xs)
        return [torch.stack([x[j].to(d, non_blocking=True) for x in xs])
                for j, d in enumerate(self.devices)]

    def _reduce(self, xs, op):
        self._check(xs)
        return [_fold([x.to(d, non_blocking=True) for x in xs], _OPS[op])
                for d in self.devices]

    def psum(self, xs):
        return self._reduce(xs, "sum")

    def pmin(self, xs):
        return self._reduce(xs, "min")

    def pmax(self, xs):
        return self._reduce(xs, "max")

    def psum_scatter(self, xs) -> List[torch.Tensor]:
        """``xs[i][j]`` is shard i's part for shard j (n parts of one
        shape each); shard j gets the sum over i of ``xs[i][j]``, folded
        in shard order."""
        self._check(xs)
        return [_fold([x[j].to(d, non_blocking=True) for x in xs], torch.add)
                for j, d in enumerate(self.devices)]


class GroupComm:
    """The same collectives over a ``torch.distributed`` process group:
    this process is shard ``rank`` and passes one-entry lists. Its shard
    lives on ``device`` — the current card by default, raising without
    one; a gloo group on the CPU passes ``device="cpu"``. ``mesh`` (the
    group's ranks as a mesh's shards, rank j as shard j) lets
    :meth:`axis` cut the group along an axis."""

    def __init__(self, group=None, device: Optional[Device] = None, *,
                 mesh: Optional[Mesh] = None):
        import torch.distributed as dist
        self._device = resolve_device(
            torch.device("cuda", torch.cuda.current_device())
            if device is None and torch.cuda.is_available() else device)
        if not dist.is_initialized():
            raise RuntimeError("GroupComm needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        if mesh is not None and mesh.size != self.n:
            raise ValueError(f"a mesh of {mesh.size} shards for a group of "
                             f"{self.n} ranks")
        self.mesh = mesh
        self.shards = [self.rank]
        self.devices = [self._device]

    def device(self, j: int) -> torch.device:
        return self._device

    def axis(self, name: str) -> "GroupComm":
        """The comm along ``name`` through this rank: a :class:`GroupComm`
        over a new process group of the ranks that share this rank's
        other coordinates, ranked in their order along ``name``. Every
        rank of the group must call it (``new_group`` is collective: each
        rank makes every group along the axis, in the same order)."""
        if self.mesh is None:
            raise ValueError("GroupComm.axis needs the group's mesh "
                             "(GroupComm(..., mesh=...))")
        return self.split(self.mesh.axis_groups(name))[0][1]

    def split(self, groups: Sequence[Sequence[int]]
              ) -> List[Tuple[List[int], "GroupComm"]]:
        """``[(members, comm)]`` for the one group of ``groups`` (lists of
        this group's ranks, each ascending) that holds this rank: a
        :class:`GroupComm` over a new process group of its members, ranked
        in their order. Every rank must call it with the same ``groups``
        (``new_group`` is collective: each rank makes every group, in the
        same order)."""
        out = []
        for ranks in groups:
            world = [r if self.group is None
                     else self._dist.get_global_rank(self.group, r)
                     for r in ranks]
            group = self._dist.new_group(world)
            if self.rank in ranks:
                out.append((list(ranks), GroupComm(group, self._device)))
        if len(out) != 1:
            raise ValueError(f"rank {self.rank} is in {len(out)} of the "
                             f"groups {groups}")
        return out

    def _one(self, xs) -> torch.Tensor:
        if len(xs) != 1:
            raise ValueError(f"a process holds one shard, got {len(xs)}")
        return xs[0].contiguous()

    def all_gather(self, xs):
        x = self._one(xs)
        out = [torch.empty_like(x) for _ in range(self.n)]
        self._dist.all_gather(out, x, group=self.group)
        return [torch.stack(out)]

    def all_to_all(self, xs):
        x = self._one(xs)
        if x.shape[0] != self.n:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.n}, got {tuple(x.shape)}")
        out = [torch.empty_like(x[0]) for _ in range(self.n)]
        self._dist.all_to_all(out, [t.contiguous() for t in x.unbind(0)],
                              group=self.group)
        return [torch.stack(out)]

    def _reduce(self, xs, op):
        # gather and fold in rank order: the same bits as LocalComm
        return [_fold(list(self.all_gather(xs)[0].unbind(0)), _OPS[op])]

    def psum_scatter(self, xs):
        """``xs[0][j]`` is this rank's part for rank j; this rank gets the
        sum over ranks of their parts for it, folded in rank order (the
        same bits as LocalComm)."""
        if len(xs) != 1:
            raise ValueError(f"a process holds one shard, got {len(xs)}")
        parts = xs[0]
        return [_fold(list(self.all_to_all([torch.stack(
            [t.contiguous() for t in parts])])[0].unbind(0)), torch.add)]

    def psum(self, xs):
        return self._reduce(xs, "sum")

    def pmin(self, xs):
        return self._reduce(xs, "min")

    def pmax(self, xs):
        return self._reduce(xs, "max")


def comm_for(mesh_or_comm) -> Union[LocalComm, GroupComm]:
    """A :class:`Mesh` as its :class:`LocalComm`; a comm as itself."""
    if isinstance(mesh_or_comm, Mesh):
        return LocalComm(mesh_or_comm)
    if isinstance(mesh_or_comm, (LocalComm, GroupComm)):
        return mesh_or_comm
    raise TypeError(f"expected a Mesh, LocalComm or GroupComm, got "
                    f"{type(mesh_or_comm).__name__}")


class _PsumFwd(torch.autograd.Function):
    """A psum over ``comm`` whose backward is the identity."""

    @staticmethod
    def forward(ctx, comm, *xs):
        return tuple(comm.psum(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


class _PsumBwd(torch.autograd.Function):
    """The identity whose backward is a psum over ``comm``."""

    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.comm.psum(list(grads)))


def _differentiable(xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def psum_fwd(comm, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``comm.psum(xs)``; under autograd the gradient of each shard's
    input is the gradient of its own output (module docstring)."""
    if not _differentiable(xs):
        return comm.psum(list(xs))
    return list(_PsumFwd.apply(comm, *xs))


def psum_bwd(comm, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``xs`` as they are; under autograd the gradient of each shard's
    input is the psum of every shard's output gradient (module
    docstring)."""
    if not _differentiable(xs):
        return list(xs)
    return list(_PsumBwd.apply(comm, *xs))
