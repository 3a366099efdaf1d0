"""qwen3-14b [dense]: GQA + per-head q/k RMSNorm.
40L d=5120 40H (kv=8) d_ff=17408 vocab=151936. [hf:Qwen/Qwen3-14B]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    head_dim=128,
    act="swiglu",
    norm="rms",
    qk_norm=True,
    rope="std",
    rope_theta=1000000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=192, vocab=512)
