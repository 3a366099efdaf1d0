"""Registry: --arch <id> → ArchConfig (full) and reduced smoke variants."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "whisper-small",
    "granite-34b",
    "nemotron-4-15b",
    "qwen3-14b",
    "llama3.2-3b",
    "arctic-480b",
    "deepseek-v2-lite-16b",
    "qwen2-vl-7b",
    "xlstm-350m",
    "recurrentgemma-9b",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_arch(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG


def get_reduced(name: str):
    """Small same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.reduced()


def all_archs():
    return {a: get_arch(a) for a in ARCH_IDS}
