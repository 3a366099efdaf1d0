"""Production meshes of the dry run — PyTorch port of the JAX package's
``launch.mesh``. Functions, not constants: importing this module touches
no device.

The JAX package's production mesh is a 16 × 16 v5e pod ``("data",
"model")``, or two of them ``("pod", "data", "model")``. The port runs no
tensor parallelism (``train.fsdp`` refuses a ``"model"`` axis wider than
1), so its production mesh has the same device counts with no
``"model"`` axis: 256 H100s along ``"data"``, or 2 × 256 along ``("pod",
"data")``. The devices are abstract (the dry run allocates nothing, and
no card is asked for): nodes of ``NODE_CARDS`` cards joined by NVLink,
the nodes by the network.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..distributed.mesh import Mesh

__all__ = ["NODE_CARDS", "POD_CARDS", "AbstractMesh", "make_production_mesh"]

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


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """256 H100s along ``"data"``; with ``multi_pod`` 2 × 256 along
    ``("pod", "data")`` — the device counts of the JAX package's 16 × 16
    and 2 × 16 × 16 v5e meshes (data parallelism across pods)."""
    if multi_pod:
        return AbstractMesh((2, POD_CARDS), ("pod", "data"))
    return AbstractMesh((POD_CARDS,), ("data",))
