"""llama3.2-3b [dense]: small llama3 — GQA, SwiGLU, tied embeddings.
28L d=3072 24H (kv=8) d_ff=8192 vocab=128256. [hf:meta-llama/Llama-3.2-3B]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    act="swiglu",
    norm="rms",
    rope="std",
    rope_theta=500000.0,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=512)
