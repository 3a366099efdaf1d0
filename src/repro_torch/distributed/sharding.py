"""The LM's mesh layout, PyTorch port of the JAX package's
``distributed.sharding``: one rules table maps parameter (and activation)
logical axes onto mesh axes, so the models stay mesh-agnostic.

- :func:`param_pspecs` derives each leaf's placement from its tree path
  (the parameter naming convention is the contract, ``_PARAM_RULES``): a
  tuple with one entry a dimension, ``None`` (whole), a mesh axis name,
  or a tuple of axis names (split over their product, row-major) — the
  entries of the JAX package's ``PartitionSpec``.
- :func:`param_shardings` slices a tree onto a mesh: each shard's part of
  every leaf, on that shard's device.
- :func:`shard` is the identity (the JAX package constrains activations
  with it inside the models; the port's data-parallel step splits the
  batch itself, and no compiler propagates layouts).

Default mapping, as there: batch → ("pod", "data"); the model-parallel
widths (heads, ff, experts, vocab) → "model"; the fsdp dimensions
(d_model, reductions) → "data" (ZeRO-3).

The port keeps one parameter dict a layer where the JAX package stacks
each group of ``cfg.layout()`` along a leading axis; the rules match the
same path suffixes, so a per-layer leaf gets the JAX placement of its
stacked leaf without the leading ``None``. With ``cfg``, the serve mode's
replication budget counts a per-layer leaf as its whole stack (the
group's layers × its bytes), so every layer of a group lands as the JAX
stacked leaf does.

One JAX fault is not copied (ROADMAP C21): the JAX ``param_pspecs`` maps
``"kv"`` to ``"model"`` unconditionally and then raises ``KeyError`` on a
mesh without a ``model`` axis (its own training launcher's host mesh);
here ``"kv"`` resolves to ``"model"`` only where the mesh has one (and
``kv_heads_divide``), else to ``None``.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..tree import path_str, tree_map, tree_map_with_path
from .mesh import Mesh

__all__ = ["Placement", "axis_rules", "current_mesh", "logical_to_pspec",
           "shard", "param_logical_axes", "param_pspecs", "local_slices",
           "local_part", "shard_tree", "param_shardings"]

# one entry a dimension: None, a mesh axis, or a tuple of mesh axes
Placement = Tuple[Union[None, str, Tuple[str, ...]], ...]

_state = threading.local()


def _axes(mesh: Mesh) -> dict:
    names = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in names) or (None,)
    return {
        "batch": batch if len(batch) > 1 else batch[0],
        "fsdp": "data" if "data" in names else None,
        "model": "model" if "model" in names else None,
        None: None,
    }


@contextlib.contextmanager
def axis_rules(mesh: Mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def logical_to_pspec(axes: Sequence[Optional[str]],
                     mesh: Optional[Mesh] = None) -> Placement:
    """The placement of logical ``axes`` on ``mesh`` (the rules context's
    mesh by default; without one the logical names themselves)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return tuple(axes)
    table = _axes(mesh)
    return tuple(table.get(a, a) for a in axes)


def shard(x, *axes):
    """The identity. The JAX package constrains an activation's layout
    here for XLA to propagate; the port's sharded train step
    (``train.fsdp``) splits the batch across shards itself and runs each
    shard's rows whole, so there is no layout to constrain."""
    return x


# ---- parameter placements ----------------------------------------------
# path regex → logical axes of the trailing dims (a per-layer leaf has no
# stacked leading axis; a shorter rule is padded with None in front)
_PARAM_RULES = [
    (r"embed$", ("model", "fsdp")),               # (V, D) vocab-TP + FSDP
    (r"pos_embed$", (None, "fsdp")),
    (r"(q|up|gate|in|ffn_up|ffn_gate|q_rope)/w$", ("fsdp", "model")),
    # GQA/MQA kv projections: sharding (kvh·dh) over more ways than there
    # are kv heads would split heads mid-vector; "kv" resolves to "model"
    # only when kv heads divide the axis (and the mesh has one)
    (r"(k|v)/w$", ("fsdp", "kv")),
    (r"(o|down|out|ffn_down)/w$", ("model", "fsdp")),
    (r"(dkv|k_rope)/w$", ("fsdp", None)),         # MLA latent projections
    (r"(uk|uv)/w$", (None, "model")),
    (r"router/w$", ("fsdp", None)),
    (r"moe/(gate|up)$", ("model", "fsdp", None)),  # (E, D, F) expert-sharded
    (r"moe/down$", ("model", None, "fsdp")),       # (E, F, D)
    (r"(igate|fgate)/w$", (None, None)),
    (r"r_[ifzo]$", (None, None, None)),   # (H, dh, dh): H is tiny, replicate
    (r"conv/w$", (None, "model")),
    (r"(w_a|b_a|w_x|b_x|lam)$", ("model",)),
    (r"(scale|bias|f_bias|fgate_bias)$", (None,)),
    (r"lm_head$", ("fsdp", "model")),              # (D, V)
]


def _spec_for_path(path: str, ndim: int) -> tuple:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            axes = tuple(axes)
            if len(axes) > ndim:      # e.g. a vector matched a 2-D rule
                axes = axes[-ndim:] if ndim else ()
            return (None,) * (ndim - len(axes)) + axes
    return (None,) * ndim


def param_logical_axes(params: Any):
    """Tree of logical-axis tuples matching the params tree."""
    return tree_map_with_path(
        lambda p, x: _spec_for_path(path_str(p), x.dim()), params)


def _stack_sizes(cfg) -> Dict[Tuple[str, int], int]:
    """``{(list key, layer index): layers in its JAX stacked group}``."""
    from ..train.optimizer import layer_stacks
    return {(key, i): len(idx) for _, key, idx in layer_stacks(cfg)
            for i in idx}


def param_pspecs(params: Any, mesh: Mesh, *, mode: str = "train",
                 kv_heads_divide: bool = True, fsdp_over_pod: bool = False,
                 cfg=None):
    """Placements for a params (or optimizer-state) tree.

    Shape-aware: a mesh axis that does not divide its dimension is dropped
    (whisper's vocab 51,865 on a 16-wide model axis stays whole rather
    than needing padding).

    ``mode="serve"``: inference keeps weights tensor-parallel only
    ("model") and replicated across the data axis — fsdp sharding would
    gather every layer's weights on every decode step — except leaves
    that stay above 128 MiB a device after model-sharding (replicating
    arctic's expert stacks over the data axis would cost ~60 GiB a
    device). ``fsdp_over_pod`` shards fsdp over ("pod", "data") when the
    mesh has a pod axis (ZeRO-3 across pods). ``cfg`` (the model's
    config) makes the serve budget count each per-layer leaf as its JAX
    stacked group (module docstring)."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode is 'train' or 'serve', got {mode!r}")
    table = dict(_axes(mesh))
    if fsdp_over_pod and "pod" in mesh.axis_names:
        table["fsdp"] = ("pod", "data")
    # C21: the JAX package sets "model" unconditionally and raises
    # KeyError below on a mesh without a model axis
    table["kv"] = ("model" if kv_heads_divide and "model" in mesh.axis_names
                   else None)
    serve_table = dict(table)
    serve_table["fsdp"] = None
    stacks = _stack_sizes(cfg) if cfg is not None else {}

    def axis_size(a) -> int:
        if a is None:
            return 1
        if isinstance(a, tuple):
            return math.prod(mesh.shape[x] for x in a)
        return mesh.shape[a]

    budget = 128 * 2 ** 20     # ≈ 1 % of a device's memory

    def per_device_bytes(axes, leaf, reps) -> float:
        factor = 1
        for dim, a in zip(leaf.shape, [table.get(x, x) for x in axes]):
            if a and a != "data" and dim % axis_size(a) == 0:
                factor *= axis_size(a)
        return reps * leaf.numel() * leaf.element_size() / max(factor, 1)

    def to_pspec(path, leaf):
        axes = _spec_for_path(path_str(path), leaf.dim())
        use = table
        reps = stacks.get(tuple(path[:2]), 1)
        if mode == "serve" and per_device_bytes(axes, leaf, reps) <= budget:
            use = serve_table
        return tuple(a if a and dim % axis_size(a) == 0 else None
                     for dim, a in zip(leaf.shape,
                                       [use.get(x, x) for x in axes]))

    return tree_map_with_path(to_pspec, params)


def _axis_parts(mesh: Mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in entry)


def local_slices(shape: Sequence[int], placement: Placement, mesh: Mesh,
                 j: int) -> Tuple[slice, ...]:
    """The index ranges of shard ``j``'s part of a leaf of ``shape``: a
    dimension split over mesh axes (a, b, ...) is cut into their product
    of equal parts, shard j taking the part at its row-major index over
    (a, b, ...)."""
    at = mesh.coords(j)
    out = []
    for dim, entry in zip(shape, placement):
        if entry is None:
            out.append(slice(None))
            continue
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = 0
        for a in entry:
            idx = idx * mesh.shape[a] + at[a]
        size = dim // _axis_parts(mesh, entry)
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_part(x: torch.Tensor, placement: Placement, mesh: Mesh,
               j: int) -> torch.Tensor:
    """Shard ``j``'s part of ``x`` (a view)."""
    return x[local_slices(x.shape, placement, mesh, j)]


def shard_tree(tree: Any, specs: Any, mesh: Mesh, j: int,
               device=None) -> Any:
    """Shard ``j``'s part of every leaf of ``tree`` placed as ``specs``:
    contiguous copies on ``device`` (the mesh's j-th device by
    default)."""
    dev = mesh.devices[j] if device is None else device
    return tree_map(lambda x, sp: local_part(x, sp, mesh, j).to(
        dev, copy=True).contiguous(), tree, specs)


def param_shardings(params: Any, mesh: Mesh, *, mode: str = "train",
                    kv_heads_divide: bool = True,
                    fsdp_over_pod: bool = False, cfg=None,
                    shards: Optional[Sequence[int]] = None) -> List[Any]:
    """``params`` sliced onto ``mesh`` as :func:`param_pspecs` places it:
    one tree a shard of ``shards`` (every shard by default), each leaf a
    contiguous copy of that shard's part on the shard's device."""
    specs = param_pspecs(params, mesh, mode=mode,
                         kv_heads_divide=kv_heads_divide,
                         fsdp_over_pod=fsdp_over_pod, cfg=cfg)
    shards = range(mesh.size) if shards is None else shards
    return [shard_tree(params, specs, mesh, j) for j in shards]
