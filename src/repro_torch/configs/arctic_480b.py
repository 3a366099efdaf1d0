"""arctic-480b [moe]: dense-MoE hybrid — every layer has a dense FFN
residual IN PARALLEL with a 128-expert top-2 MoE.
35L d=7168 56H (kv=8) expert_ff=4864 vocab=32000.
[hf:Snowflake/snowflake-arctic-base]"""
import dataclasses

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,            # per-expert ff (the assignment's d_ff)
    vocab=32000,
    act="swiglu",
    norm="rms",
    rope="std",
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        expert_ff=4864,
        dense_residual_ff=7168,  # arctic's parallel dense MLP (2×d ratio ≈ hf cfg)
        capacity_factor=1.25,
    ),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=96,
                      dense_residual_ff=64, capacity_factor=8.0))
