"""Carry the JAX package's LM parameters into the port.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``): each scanned
group of ``cfg.layout()`` holds its layers' leaves stacked along a
leading ``reps`` axis under ``f"l{j}_{kind}"``. It returns the port's
tree: the same leaves, one dict per layer in the stack's order. Weights
keep the JAX ``(d_in, d_out)`` layout, which the port's ``dense``
applies as ``x @ w``; nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device

__all__ = ["params_from_jax"]


def _tensor(x, dtype, dev) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))          # a writable copy
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: Dict[str, Any], cfg: ArchConfig, *,
                    dtype: Optional[torch.dtype] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, Any]:
    """The port's parameter tree from the JAX one (numpy leaves), cast to
    ``dtype`` (default: keep each leaf's) on ``device``. The JAX tree's
    bfloat16 leaves must be cast to float32 on the numpy side first
    (numpy has no bfloat16)."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {
        "embed": _tensor(np_params["embed"], dtype, dev),
        "final_norm": _map(np_params["final_norm"],
                           lambda x: _tensor(x, dtype, dev)),
    }
    if "lm_head" in np_params:
        out["lm_head"] = _tensor(np_params["lm_head"], dtype, dev)
    layers = []
    for group, (unit, reps) in zip(np_params["groups"], cfg.layout()):
        for r in range(reps):
            for j, kind in enumerate(unit):
                layers.append(_map(group[f"l{j}_{kind}"],
                                   lambda x, r=r: _tensor(np.asarray(x)[r],
                                                          dtype, dev)))
    out["layers"] = layers
    return out
