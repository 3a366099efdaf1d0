"""Production meshes of the dry run — PyTorch port of the JAX package's
``launch.mesh``. Functions, not constants: importing this module touches
no device.

The JAX package's production mesh is a 16 × 16 v5e pod ``("data",
"model")``, or two of them ``("pod", "data", "model")``. The port's mesh
has the same device counts: 256 H100s, or 2 × 256. Its model axis
(:func:`model_extent`):

* the dense decoders' cells (train, prefill, decode) and the MoE
  decoders' serving cells (prefill, decode: deepseek-v2-lite-16b's and
  arctic-480b's experts and heads split) are tensor parallel over ``t =
  tensor_parallel.tp_degree(cfg, NODE_CARDS, mode)`` cards of one node:
  ``(256 / t, t)`` over ``("data", "model")``, or ``(2, 256 / t, t)``
  over ``("pod", "data", "model")`` (train: FSDP over the data axes ×
  TP, ``train.fsdp``). 8 rather than the JAX package's 16: past a node
  every layer's all-reduce would cross the network, and the port splits
  whole heads (24 and 40 do not split 16 ways);
* the other cells have none: 256 along ``"data"``, or 2 × 256 along
  ``("pod", "data")`` — the MoE decoders' train cells (training over
  ``"model"`` does not split experts or MLA yet: ROADMAP A10e) and every
  cell of the archs whose blocks are not split over ``"model"`` yet
  (ROADMAP A10c).

The devices are abstract (the dry run allocates nothing, and no card is
asked for): nodes of ``NODE_CARDS`` cards joined by NVLink, the nodes by
the network.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.mesh import Mesh
from ..distributed.tensor_parallel import (tp_degree, unsplit_blocks,
                                           unsplit_label)

__all__ = ["NODE_CARDS", "POD_CARDS", "AbstractMesh", "model_extent",
           "make_production_mesh"]

NODE_CARDS = 8      # H100s a node (an HGX H100 board: NVLink all to all)
POD_CARDS = 256     # the JAX package's pod: 16 × 16 chips


class AbstractMesh(Mesh):
    """A :class:`Mesh` whose devices are named, not resolved: shard j is
    card ``j % NODE_CARDS`` of node ``j // NODE_CARDS`` (row-major, as
    ``Mesh``). :class:`Mesh` resolves each device and raises for a card
    that is not present; this one is for accounting only (``launch.cost``
    and the train path's placements), never for tensors."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(x) for x in shape)
        names = tuple(str(x) for x in axis_names)
        if len(shape) != len(names) or not 1 <= len(shape) <= 3 \
                or len(set(names)) != len(names) or min(shape) < 1:
            raise ValueError(f"a mesh has 1 to 3 distinct named axes of "
                             f"extent >= 1, got {shape} and {names}")
        self.devices = [torch.device("cuda", j % NODE_CARDS)
                        for j in range(math.prod(shape))]
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def model_extent(arch: ArchConfig, kind: str) -> Tuple[int, str]:
    """(the cell's model axis, why): ``tp_degree(arch, NODE_CARDS,
    mode)`` for a cell whose blocks ``mode`` splits over ``"model"``,
    else 1 (module docstring)."""
    mode = "train" if kind == "train" else "serve"
    rest = unsplit_blocks(arch, mode)
    if rest:
        what = ("FSDP over the data axes, whole layers a replica"
                if kind == "train" else "whole weights a replica")
        return 1, (f"{kind}: {what}; {', '.join(rest)} not split over "
                   f"'model' for {mode} yet "
                   f"({unsplit_label(arch, mode)})")
    t = tp_degree(arch, NODE_CARDS, mode)
    how = "FSDP over the data axes × " if kind == "train" else ""
    what = (f"heads {arch.n_heads // t}, kv heads "
            f"{max(arch.n_kv_heads // t, 1)}")
    if arch.mla is not None:
        what = f"heads {arch.n_heads // t}, MLA's latent whole"
    if arch.moe is not None:
        what += (f", experts {arch.moe.n_experts // t} of "
                 f"{arch.moe.n_experts} (routed on every shard)")
    return t, (f"{kind}: {how}tensor parallel over 'model' = {t} cards of "
               f"a node ({what} a shard)")


def make_production_mesh(*, multi_pod: bool = False,
                         model: int = 1) -> AbstractMesh:
    """256 H100s along ``"data"``; with ``multi_pod`` 2 × 256 along
    ``("pod", "data")`` — the device counts of the JAX package's 16 × 16
    and 2 × 16 × 16 v5e meshes (data parallelism across pods). With
    ``model`` > 1 the last axis is ``"model"`` of that extent: ``(256 /
    model, model)``, or ``(2, 256 / model, model)``."""
    lead = ((2,), ("pod",)) if multi_pod else ((), ())
    if model == 1:
        return AbstractMesh(lead[0] + (POD_CARDS,), lead[1] + ("data",))
    if POD_CARDS % model:
        raise ValueError(f"a model axis of {model} does not divide a pod "
                         f"of {POD_CARDS}")
    return AbstractMesh(lead[0] + (POD_CARDS // model, model),
                        lead[1] + ("data", "model"))
