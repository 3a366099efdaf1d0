"""qwen2-vl-7b [vlm]: backbone only — M-RoPE 3-axis rotary; the vision
tower is a STUB (input_specs supplies 64 precomputed patch embeddings).
28L d=3584 28H (kv=4) d_ff=18944 vocab=152064. [arXiv:2409.12191]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    act="swiglu",
    norm="rms",
    rope="mrope",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),   # halves of head_dim=128 → 64 = 16+24+24
    n_vision_embeds=64,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=512, mrope_sections=(2, 3, 3), n_vision_embeds=4)
