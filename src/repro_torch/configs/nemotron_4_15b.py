"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP, LayerNorm.
32L d=6144 48H (kv=8) d_ff=24576 vocab=256000. [arXiv:2402.16819]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="relu2",          # squared ReLU, non-gated (2 matrices)
    norm="ln",
    rope="std",
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512)
