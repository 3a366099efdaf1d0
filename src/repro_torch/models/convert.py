"""Carry the JAX package's LM parameters into the port.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``): each scanned
group of ``cfg.layout()`` holds its layers' leaves stacked along a
leading ``reps`` axis under ``f"l{j}_{kind}"``, and whisper's encoder
stack (``params["encoder"]``) likewise. It returns the port's tree: the
same leaves, one dict per layer in the stack's order. Weights
keep the JAX ``(d_in, d_out)`` layout, which the port's ``dense``
applies as ``x @ w``; nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..configs.base import ATTN_BIDIR, ArchConfig
from ..device import resolve_device
from .recurrent import FLOAT32_LEAVES

__all__ = ["params_from_jax"]


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


def _unstack(group, unit, reps: int, fn) -> list:
    """One dict per layer out of a scanned group (leaves stacked along a
    leading ``reps`` axis under ``f"l{j}_{kind}"``)."""
    return [_map(group[f"l{j}_{kind}"],
                 lambda x, name, r=r: fn(np.asarray(x)[r], name))
            for r in range(reps) for j, kind in enumerate(unit)]


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
