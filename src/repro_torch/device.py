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

__all__ = ["resolve_device"]


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
