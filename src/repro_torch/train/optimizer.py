"""AdamW and Adafactor (factored second moment), PyTorch port of the JAX
package's ``train.optimizer``.

Parity with the JAX optimizer on the same gradients:

* The step math is float32, as there: ``lr_schedule`` and the bias
  corrections ``b1 ** step`` run on float32 tensors (a Python float
  power would be float64 and move the update), and the clip scales each
  gradient by the clip factor cast to the gradient's dtype.
* The JAX package stacks each ``(unit, reps)`` group of ``cfg.layout()``
  (and whisper's encoder) along a leading ``reps`` axis, and maps the
  update over that axis only for stacked leaves of ndim >= 3. So a
  per-layer leaf of ndim <= 1 (a norm scale, a bias,
  ``recurrent.FLOAT32_LEAVES``) is one ``(reps, d)`` leaf there, which
  Adafactor factors across the group's layers, with one RMS(u) <= 1
  update clip over all of them. The port keeps one dict per layer, so
  its Adafactor stacks those leaves of each group (:func:`layer_stacks`,
  ``torch.stack``, update, unstack) and keeps their factored state
  under ``state["stacked"]``, keyed by the JAX group path; wider
  per-layer leaves are updated per layer, as the JAX ``lax.map`` does.
  AdamW is elementwise, so it needs no stacking.
* bf16 parameters keep a float32 ``master`` under AdamW; float32 leaves
  stay float32.

The state is updated in place (the JAX package returns a new one; at
full width a second copy of a 3.2e9-parameter AdamW state would not fit
the card beside the first) and returned; the parameters come back as new
tensors, and the gradients are not modified.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import ATTN_BIDIR, ArchConfig
from ..tree import (get_path, leaves, leaves_with_path, tree_map,
                   tree_map_with_path)

__all__ = ["OptConfig", "lr_schedule", "global_norm", "clip_scale",
           "layer_stacks", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "make_optimizer"]

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999            # adafactor: decay exponent handled below
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(
        step < cfg.warmup_steps, warm,
        cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_scale(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the clip factor min(1, max_norm / max(norm, 1e-9)), the norm):
    each gradient is used as ``g * scale.to(g.dtype)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return scale, norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # cast the scale, not the gradient (as the JAX package: bf16·f32 would
    # promote every leaf to a full-size f32 temporary)
    return (g * scale.to(g.dtype)).to(torch.float32)


def _step_tensor(params) -> torch.Tensor:
    dev = next(iter(leaves(params))).device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ------------------------------------------------------------------ AdamW
def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
        "step": _step_tensor(params),
    }


def adamw_update(grads, state, params, cfg: OptConfig):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, mu, nu, master):
        g = _clipped(g, scale)
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        del g
        master.sub_(lr * (delta + cfg.weight_decay * master))
        return master.to(p.dtype, copy=True)

    new_params = tree_map(upd, params, grads, state["mu"], state["nu"],
                          state["master"])
    state["step"] = step
    return new_params, state, {"grad_norm": gnorm, "lr": lr}


# -------------------------------------------------------------- Adafactor
def layer_stacks(arch: ArchConfig) -> List[Tuple[str, str, List[int]]]:
    """The JAX package's stacked groups over the port's per-layer lists:
    ``(JAX group path, the port's list key, the layer indices stacked)``
    for each kind of each ``(unit, reps)`` group of ``arch.layout()``
    (``groups/<g>/l<j>_<kind>`` over ``params["layers"]``) and for
    whisper's encoder (``encoder/l0_attn_bidir`` over
    ``params["encoder"]``)."""
    out, start = [], 0
    for gi, (unit, reps) in enumerate(arch.layout()):
        for j, kind in enumerate(unit):
            out.append((f"groups/{gi}/l{j}_{kind}", "layers",
                        [start + r * len(unit) + j for r in range(reps)]))
        start += reps * len(unit)
    if arch.n_enc_layers:
        out.append((f"encoder/l0_{ATTN_BIDIR}", "encoder",
                    list(range(arch.n_enc_layers))))
    return out


def _factored_dims(shape):
    """Last two non-trivial dims, or None if the tensor is <= 1-D."""
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def _factor_state(shape, device) -> Dict[str, torch.Tensor]:
    dims = _factored_dims(shape)
    if dims is None:
        return {"v": torch.zeros(shape, dtype=torch.float32, device=device)}
    r, c = dims
    return {"vr": torch.zeros(shape[:c] + shape[c + 1:], dtype=torch.float32,
                              device=device),
            "vc": torch.zeros(shape[:r] + shape[r + 1:], dtype=torch.float32,
                              device=device)}


def _stacked_leaves(params, stacks) -> Dict[str, Tuple[str, list, tuple]]:
    """``{JAX path: (list key, layer indices, path in a layer)}`` of the
    per-layer leaves of ndim <= 1 that the JAX package keeps stacked."""
    out = {}
    for name, key, idx in stacks:
        for sub, leaf in leaves_with_path(params[key][idx[0]]):
            if leaf.dim() <= 1:
                out["/".join([name, *map(str, sub)])] = (key, idx, sub)
    return out


def adafactor_init(params, stacks=()) -> Dict[str, Any]:
    stacked = _stacked_leaves(params, stacks)
    skip = {(key, i) + sub for key, idx, sub in stacked.values()
            for i in idx}

    def make(path, p):
        return {} if path in skip else _factor_state(tuple(p.shape),
                                                     p.device)

    return {
        "v": tree_map_with_path(make, params),
        "stacked": {name: _factor_state(
            (len(idx),) + tuple(get_path(params[key][idx[0]], sub).shape),
            get_path(params[key][idx[0]], sub).device)
            for name, (key, idx, sub) in stacked.items()},
        "step": _step_tensor(params),
    }


def _adafactor_leaf(g, v, p, lr, decay, scale, cfg: OptConfig):
    """One leaf's update (the JAX ``upd``); ``v`` is updated in place."""
    g = _clipped(g, scale)
    g2 = g * g + 1e-30
    dims = _factored_dims(g.shape)
    if dims is None:
        v["v"].mul_(decay).add_((1 - decay) * g2)
        prec = torch.rsqrt(v["v"] + 1e-30)
    else:
        r, c = dims
        # vr: per-row stats (mean over the column dim); vc: per-column
        v["vr"].mul_(decay).add_((1 - decay) * torch.mean(g2, dim=c))
        v["vc"].mul_(decay).add_((1 - decay) * torch.mean(g2, dim=r))
        r_ = v["vr"] / torch.clamp(torch.mean(v["vr"], dim=-1, keepdim=True),
                                   min=1e-30)
        prec = torch.rsqrt(r_.unsqueeze(c) * v["vc"].unsqueeze(r) + 1e-30)
    del g2
    u = g * prec
    # update clipping (Shazeer & Stern): RMS(u) <= 1
    rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp(rms_u, min=1.0)
    pf = p.to(torch.float32)
    return (pf - lr * (u + cfg.weight_decay * pf)).to(p.dtype)


def adafactor_update(grads, state, params, cfg: OptConfig, stacks=()):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8
    stacked = _stacked_leaves(params, stacks)

    def upd(path, p):
        v = get_path(state["v"], path)
        if not v:                       # a stacked leaf: updated below
            return None
        return _adafactor_leaf(get_path(grads, path), v, p, lr, decay,
                               scale, cfg)

    new_params = tree_map_with_path(upd, params)
    for name, (key, idx, sub) in stacked.items():
        p = torch.stack([get_path(params[key][i], sub) for i in idx])
        g = torch.stack([get_path(grads[key][i], sub) for i in idx])
        newp = _adafactor_leaf(g, state["stacked"][name], p, lr, decay,
                               scale, cfg)
        for r, i in enumerate(idx):
            parent = get_path(new_params[key][i], sub[:-1])
            parent[sub[-1]] = newp[r].clone()
    state["step"] = step
    return new_params, state, {"grad_norm": gnorm, "lr": lr}


def make_optimizer(cfg: OptConfig, arch: Optional[ArchConfig] = None
                   ) -> Tuple[Callable, Callable]:
    """``(init(params), update(grads, state, params))``. ``arch`` gives
    Adafactor the JAX package's stacked groups (:func:`layer_stacks`);
    without it every leaf is its own, as for a tree that is no model's."""
    stacks = layer_stacks(arch) if arch is not None else ()
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(g, s, p, cfg)
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(p, stacks),
                lambda g, s, p: adafactor_update(g, s, p, cfg, stacks))
    raise ValueError(cfg.name)
