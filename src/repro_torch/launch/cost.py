"""Cost accounting of one device's step, traced over meta tensors — the
port's counterpart of the JAX package's ``launch/hlo_analysis.py``.

The JAX dry run compiles each cell and parses the partitioned HLO. The
port runs eager PyTorch, so it has no HLO: :func:`trace_step` runs one
device's step over tensors on the ``meta`` device (shapes, dtypes and
strides, no data: nothing is allocated and no card is needed) under one
dispatch mode that sees every aten and ``repro_torch`` operator, and
counts, per device:

- **flops** with ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` reads): the matrix products by their shapes, and
  K-F and K-B by the formulas their operators register
  (``kernels.flash_attention``: 2·(d + d_v) and 2·(3d + 2·d_v) a visible
  pair a head) — hlo_analysis counts dots, 2 · |result| ·
  |contraction|, the same rule. ``FlopCounterMode`` itself gives the
  same count (``chip_smoke.py`` phase 25 holds them equal over a real
  step on the card) at ~37 µs of bookkeeping an op, three times the
  rest of the trace;
- **HBM bytes** as the operands plus the result of each aten or
  ``repro_torch`` operator — hlo_analysis's rule for a fusion, applied
  to eager ops, each of which reads its inputs and writes its outputs
  once. Views and allocations move nothing and count nothing; a
  collective counts its operand and its result;
- **memory** from the storages' lives (each storage counted once, from
  the op that creates it to the moment it is freed, as the caching
  allocator's ``max_memory_allocated`` sees it): the arguments', the
  outputs' (apart from those that alias an argument, such as an
  optimizer state updated in place) and the peak of everything live;
  ``temp = peak − argument − output + alias``, so ``peak = argument +
  output + temp − alias`` as in the JAX dry run's record;
- **collective bytes by kind** from :class:`RecordingComm`, one rank's
  stand-in for ``distributed.mesh.GroupComm``: each collective adds its
  result's bytes (the JAX dry run's convention, ``dryrun.py:51``), and
  **by link**: a group within one node of the abstract mesh moves its
  bytes over NVLink, a group that spans nodes over the network (the 2-D
  train step: the model axis's forward and backward all-reduces within a
  node, the data axis's gather and reduce-scatter across nodes). A MoE
  FFN over a model axis records one all-reduce after it, where the JAX
  dry run records the all-to-all that GSPMD inserts for its experts:
  the port's shards route every token on every shard
  (``distributed.tensor_parallel``), so no token crosses.

Why meta tensors and not ``FakeTensorMode``: a fake tensor is a meta
tensor with a device attached, and its mode's Python dispatch costs
400–880 µs an op on an Intel Xeon host, against 3.5 µs for a meta
kernel written in C++ (an elementwise op's meta kernel is Python,
~100 µs). A train cell over 256 ranks runs 0.9 million
ops (``FSDPTrainer``'s gather and reduce-scatter loop over the ranks),
120 s under ``FakeTensorMode``. What the device would change (none of
shapes, flops or bytes) the record states: the port's program on the
card. The parameters and caches come from ``init_params`` /
``init_cache`` under ``FakeTensorMode`` (a few thousand ops), as meta
tensors of their shapes (:func:`abstract`).

hlo_analysis's XLA-only parts have no counterpart: there is no
while-loop trip count to scale by (eager tracing runs every layer and
every accumulation step), and no ``cpu_bf16_convert_staging_bytes``
(XLA-CPU's f32 staging buffers; the port's trace allocates what the card
would). Kernels' own scratch (K-F's split-KV partials, K-B's row sums)
is not counted: their fake kernels return the outputs only.

Data-dependent shapes. A meta tensor has no values, so an operator whose
output size depends on them (a boolean-mask index: the MoE's kept
choices) is counted at the most the data could need: every element
selected.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

__all__ = ["COLL_KINDS", "StepCost", "RecordingComm", "trace_step",
           "tensor_bytes", "storage_bytes", "abstract"]

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_aten = torch.ops.aten
# allocations and aliasing ops that move no bytes
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.detach.default, _aten.alias.default, _aten.lift_fresh.default,
    torch.ops.prim.device.default,
}
_MASK_INDEXING = {_aten.index.Tensor, _aten.index_put.default,
                  _aten.index_put_.default, _aten._index_put_impl_.default}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of every tensor in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass
class StepCost:
    """One device's step: flops (by operator), HBM bytes, memory and
    collective bytes (module docstring)."""
    flops: int = 0
    flops_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives_by_link: Dict[str, int] = dataclasses.field(
        default_factory=dict)      # "nvlink" / "network": result bytes
    n_ops: int = 0                  # the operators traced

    @property
    def temp_bytes(self) -> int:
        return (self.peak_bytes - self.argument_bytes - self.output_bytes
                + self.alias_bytes)

    def memory(self) -> Dict[str, int]:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes,
                "peak_bytes": self.peak_bytes}


class RecordingComm:
    """``GroupComm``'s interface for rank 0 of ``n`` (one shard a
    process), with no process group: each collective returns a result of
    the shape ``GroupComm``'s would have, on the operand's (meta) device,
    and adds the result's bytes to its kind (``all_gather`` → all-gather,
    ``psum`` / ``pmin`` / ``pmax`` → all-reduce, ``psum_scatter`` →
    reduce-scatter, ``all_to_all`` → all-to-all) and to its link.
    ``GroupComm`` carries out its reductions through an all-gather (or an
    all-to-all) and folds in rank order, for the same bits as one
    process; the bytes recorded are the collective's, not that
    implementation's. ``spans_nodes``: whether the group crosses nodes
    (its bytes go over the network, else NVLink). :meth:`split` gives the
    comm of rank 0's group among groups of the ranks (nodes of
    ``node_cards`` ranks), which records into this one."""

    def __init__(self, n: int, device, *, spans_nodes: bool = False,
                 node_cards: Optional[int] = None, _root=None):
        self.n, self.rank = int(n), 0
        self.shards = [self.rank]
        self._device = torch.device(device)
        self.devices = [self._device]
        self.spans_nodes = spans_nodes
        self.node_cards = node_cards
        self.link = "network" if spans_nodes else "nvlink"
        self.root = self if _root is None else _root
        if _root is None:
            self.bytes = {kind: 0 for kind in COLL_KINDS}
            self.link_bytes = {"nvlink": 0, "network": 0}
            self.hbm_bytes = 0      # each collective's operand + result

    def device(self, j: int) -> torch.device:
        return self._device

    def split(self, groups: Sequence[Sequence[int]]) -> list:
        """``[(members, comm)]`` for the group of ``groups`` (lists of
        ranks) that holds rank 0: a comm of its size that records into
        this one, over the network where its ranks sit on several nodes
        (``node_cards`` ranks a node)."""
        members = next(list(g) for g in groups if self.rank in g)
        nodes = ({j // self.node_cards for j in members}
                 if self.node_cards else {0})
        return [(members, RecordingComm(
            len(members), self._device, spans_nodes=len(nodes) > 1,
            node_cards=self.node_cards, _root=self.root))]

    def _one(self, xs) -> torch.Tensor:
        if len(xs) != 1:
            raise ValueError(f"a process holds one shard, got {len(xs)}")
        return xs[0]

    def _record(self, kind: str, operand: int, out: torch.Tensor) -> list:
        root = self.root
        root.bytes[kind] += tensor_bytes(out)
        root.link_bytes[self.link] += tensor_bytes(out)
        root.hbm_bytes += operand + tensor_bytes(out)
        return [out]

    def all_gather(self, xs):
        x = self._one(xs)
        return self._record("all-gather", tensor_bytes(x),
                            x.new_empty((self.n,) + tuple(x.shape)))

    def all_to_all(self, xs):
        x = self._one(xs)
        if x.shape[0] != self.n:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.n}, got {tuple(x.shape)}")
        return self._record("all-to-all", tensor_bytes(x),
                            x.new_empty(x.shape))

    def _reduce(self, xs):
        x = self._one(xs)
        return self._record("all-reduce", tensor_bytes(x),
                            x.new_empty(x.shape))

    psum = pmin = pmax = _reduce

    def psum_scatter(self, xs):
        parts = self._one(xs)
        if len(parts) != self.n:
            raise ValueError(f"psum_scatter needs {self.n} parts, got "
                             f"{len(parts)}")
        return self._record("reduce-scatter",
                            sum(tensor_bytes(p) for p in parts),
                            parts[self.rank].new_empty(
                                parts[self.rank].shape))


def _selected(mask: torch.Tensor) -> List[torch.Tensor]:
    """The int64 index tensors of a boolean mask with every element
    selected (``mask.nonzero()``'s columns at their largest)."""
    n = mask.numel()
    return [torch.zeros((n,), dtype=torch.int64, device=mask.device)
            for _ in range(mask.dim())]


def _expand_masks(indices):
    out = []
    for ix in indices:
        if ix is not None and ix.dtype == torch.bool:
            out.extend(_selected(ix))
        else:
            out.append(ix)
    return out


def _flat_tensors(args, kwargs) -> List[torch.Tensor]:
    """The tensors among an op's arguments (one level of lists, as aten
    schemas have them)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class _Tracker(TorchDispatchMode):
    """Counts HBM bytes and follows the storages' lives (module
    docstring); rewrites boolean-mask indexing to every element."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.n_ops = 0
        self.flops: Dict[Any, int] = {}
        self._refs: Dict[int, Tuple[Any, int]] = {}

    def hold(self, tree) -> None:
        for t in _tensors(tree):
            self._add(t)
        self.peak = max(self.peak, self.live)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        size = st.nbytes()
        self._refs[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                           size)
        self.live += size

    def _free(self, key: int) -> None:
        self.live -= self._refs.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MASK_INDEXING and any(
                ix is not None and ix.dtype == torch.bool for ix in args[1]):
            args = (args[0], _expand_masks(args[1])) + tuple(args[2:])
        if func is _aten.nonzero.default:
            x = args[0]
            out = torch.zeros((x.numel(), x.dim()), dtype=torch.int64,
                              device=x.device)
        else:
            out = func(*args, **kwargs)
        self.n_ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            packet = func._overloadpacket
            self.flops[packet] = self.flops.get(packet, 0) + int(
                formula(*args, **kwargs, out_val=out))
        if isinstance(out, torch.Tensor):
            outs = [out]
        elif isinstance(out, (list, tuple)):
            outs = [x for x in out if isinstance(x, torch.Tensor)]
        else:
            outs = []
        if not (func.is_view or func in _NO_TRAFFIC):
            self.bytes += sum(map(tensor_bytes, _flat_tensors(args, kwargs)))
            self.bytes += sum(map(tensor_bytes, outs))
        for t in outs:
            self._add(t)
        if self.live > self.peak:
            self.peak = self.live
        return out


def trace_step(step: Callable, args: Sequence[Any], *,
               comm: Optional[RecordingComm] = None
               ) -> Tuple[Any, StepCost]:
    """Run ``step(*args)`` once over meta tensors and count it (module
    docstring). ``args`` stay held for the whole step, as a caller holds
    them; ``comm`` is the step's :class:`RecordingComm`, if it has one.
    Returns (the step's meta outputs, its :class:`StepCost`)."""
    tracker = _Tracker()
    tracker.hold(args)
    arg_keys = {id(t.untyped_storage()) for t in _tensors(args)}
    with tracker:
        out = step(*args)
    cost = StepCost()
    cost.flops = sum(tracker.flops.values())
    cost.flops_by_op = {str(op): n for op, n in tracker.flops.items()}
    cost.bytes = tracker.bytes + (comm.hbm_bytes if comm else 0)
    cost.argument_bytes = storage_bytes(args)
    outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(out)}
    cost.output_bytes = sum(outs.values())
    cost.alias_bytes = sum(n for k, n in outs.items() if k in arg_keys)
    cost.peak_bytes = tracker.peak
    cost.n_ops = tracker.n_ops
    if comm is not None:
        cost.collectives = dict(comm.bytes)
        cost.collectives_by_link = dict(comm.link_bytes)
    return out, cost


def _to_meta(tree):
    """``tree`` with every tensor replaced by a meta tensor of its shape,
    dtype and strides; tensors that share a storage (a cache's views of
    one buffer) share one meta storage, at the same offsets."""
    bases: Dict[int, torch.Tensor] = {}

    def conv(x):
        if not isinstance(x, torch.Tensor):
            return x
        st = x.untyped_storage()
        base = bases.get(id(st))
        if base is None:
            base = bases[id(st)] = torch.empty(
                (st.nbytes() // x.element_size(),), dtype=x.dtype,
                device="meta")
        return base.as_strided(x.shape, x.stride(), x.storage_offset())

    return tree_map(conv, tree)


def abstract(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` (a model's ``init_params`` or
    ``init_cache`` on the CPU) run under ``FakeTensorMode``, its tensors
    returned as meta tensors: their shapes and dtypes, with nothing
    drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return _to_meta(out)
