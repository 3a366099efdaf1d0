"""granite-34b [dense]: llama-arch code model, MQA.
88L d=6144 48H (kv=1) d_ff=24576 vocab=49152. [arXiv:2405.04324]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="swiglu",
    norm="rms",
    rope="std",
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab=256)
