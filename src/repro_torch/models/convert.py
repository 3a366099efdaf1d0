"""Carry the JAX package's LM parameters into the port.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``): each scanned
group of ``cfg.layout()`` holds its layers' leaves stacked along a
leading ``reps`` axis under ``f"l{j}_{kind}"``, and whisper's encoder
stack (``params["encoder"]``) likewise. It returns the port's tree: the
same leaves, one dict per layer in the stack's order. Weights
keep the JAX ``(d_in, d_out)`` layout, which the port's ``dense``
applies as ``x @ w``; nothing is transposed. The same mapping carries a
JAX gradient or updated parameter tree across, and ``opt_state_from_jax``
an optimizer state (``repro_torch.train``'s layout: Adafactor's factored
moments of per-layer leaves of ndim <= 1 stay stacked, as the JAX
package updates them).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..configs.base import ATTN_BIDIR, ArchConfig
from ..device import resolve_device
from ..tree import path_str, tree_map_with_path
from .recurrent import FLOAT32_LEAVES

__all__ = ["params_from_jax", "opt_state_from_jax"]


def _tensor(x, dtype, dev) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))          # a writable copy
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def _map(tree, fn, name: str = ""):
    """``fn(leaf, name)`` over a tree of dicts and lists, ``name`` the
    leaf's dict key."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):      # MoE's shared experts
        return [_map(v, fn, name) for v in tree]
    return fn(tree, name)


def _layer_keys(unit, reps: int) -> list:
    """``(r, f"l{j}_{kind}")`` of each layer of a scanned group, in the
    stack's order: layer ``r`` of the unit's ``j``-th kind."""
    return [(r, f"l{j}_{kind}") for r in range(reps)
            for j, kind in enumerate(unit)]


def _unstack(group, unit, reps: int, fn) -> list:
    """One dict per layer out of a scanned group (leaves stacked along a
    leading ``reps`` axis under ``f"l{j}_{kind}"``)."""
    return [_map(group[key], lambda x, name, r=r: fn(np.asarray(x)[r], name))
            for r, key in _layer_keys(unit, reps)]


def params_from_jax(np_params: Dict[str, Any], cfg: ArchConfig, *,
                    dtype: Optional[torch.dtype] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, Any]:
    """The port's parameter tree from the JAX one (numpy leaves), cast to
    ``dtype`` (default: keep each leaf's) on ``device`` — except the
    recurrent leaves the JAX package keeps float32 in any model
    (``recurrent.FLOAT32_LEAVES``), which stay float32. The JAX tree's
    bfloat16 leaves must be cast to float32 on the numpy side first
    (numpy has no bfloat16)."""
    dev = resolve_device(device)

    def leaf(x, name: str) -> torch.Tensor:
        keep = dtype is not None and name in FLOAT32_LEAVES
        return _tensor(x, torch.float32 if keep else dtype, dev)

    out: Dict[str, Any] = {name: _map(np_params[name], leaf, name)
                           for name in ("embed", "final_norm", "lm_head",
                                        "pos_embed", "enc_norm",
                                        "enc_pos_embed")
                           if name in np_params}
    layers = []
    for group, (unit, reps) in zip(np_params["groups"], cfg.layout()):
        layers += _unstack(group, unit, reps, leaf)
    out["layers"] = layers
    if "encoder" in np_params:
        out["encoder"] = _unstack(np_params["encoder"], (ATTN_BIDIR,),
                                  cfg.n_enc_layers, leaf)
    return out


def _is_factor(node) -> bool:
    """An Adafactor moment entry: ``{"v": a}`` or ``{"vr": a, "vc": b}``."""
    return (isinstance(node, dict) and set(node) in ({"v"}, {"vr", "vc"})
            and not any(isinstance(x, (dict, list, tuple))
                        for x in node.values()))


def opt_state_from_jax(np_state: Dict[str, Any], cfg: ArchConfig, *,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, Any]:
    """The port's optimizer state (``train.optimizer``) from a JAX one
    (numpy leaves), so that a state made by JAX can be continued in the
    port. AdamW: ``mu``, ``nu`` and ``master`` mapped as parameters.
    Adafactor: each moment entry of a scanned group unstacked per layer,
    except those of per-layer leaves of ndim <= 1 (a ``vr`` of one axis,
    or a ``v``), which the JAX package factors across the group's layers:
    they go, stacked, under ``state["stacked"]`` keyed by their JAX path
    (``train.optimizer.layer_stacks``), and the layer's entry is ``{}``."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(np_state["step"])), dtype=torch.int32,
                        device=dev)
    if "mu" in np_state:
        return {**{k: params_from_jax(np_state[k], cfg, device=dev)
                   for k in ("mu", "nu", "master")}, "step": step}
    v = np_state["v"]

    def entry(e, r=None) -> Dict[str, torch.Tensor]:
        return {k: _tensor(x if r is None else np.asarray(x)[r], None, dev)
                for k, x in e.items()}

    out: Dict[str, Any] = {
        name: tree_map_with_path(lambda _, e: entry(e), v[name],
                                 is_leaf=_is_factor)
        for name in ("embed", "final_norm", "lm_head", "pos_embed",
                     "enc_norm", "enc_pos_embed") if name in v}
    stacked: Dict[str, Any] = {}

    def unstack(group, unit, reps: int, prefix: str) -> list:
        def layer(r):
            def one(path, e):
                if "v" in e or np.asarray(e["vr"]).ndim == 1:
                    if r == 0:
                        stacked[path_str(path)] = entry(e)
                    return {}
                return entry(e, r)
            return one
        return [tree_map_with_path(layer(r), group[key], (prefix, key),
                                   is_leaf=_is_factor)
                for r, key in _layer_keys(unit, reps)]

    out["layers"] = []
    for gi, (group, (unit, reps)) in enumerate(zip(v["groups"],
                                                   cfg.layout())):
        out["layers"] += unstack(group, unit, reps, f"groups/{gi}")
    if "encoder" in v:
        out["encoder"] = unstack(v["encoder"], (ATTN_BIDIR,),
                                 cfg.n_enc_layers, "encoder")
    return {"v": out, "stacked": stacked, "step": step}
