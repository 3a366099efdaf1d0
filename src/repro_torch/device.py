"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. On a
machine without a usable card that default raises instead of carrying
on silently on the CPU; the CPU runs only when the caller asks for it
(``device="cpu"``), and then every kernel wrapper takes its plain
PyTorch version.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "SMS", "BLOCKS_PER_SM"]

# The card the kernels' grids are cut for: an H100 SXM's streaming
# multiprocessors, and the blocks per SM that K-D's, K-G's and K-F's
# host-side split planners aim at.
SMS = 132
BLOCKS_PER_SM = 4


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
