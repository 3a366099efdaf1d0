"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 2 shared / 64 routed
top-6 experts, first layer dense. 27L d=2048 16H expert_ff=1408
vocab=102400. [arXiv:2405.04434]

Assignment-line discrepancy (see DESIGN.md §4.1): header says "MoE 64e
top-6", trailer says "160 routed" (that's the 236B model). We follow the
header: 64 routed experts, top-6, plus 2 shared.
"""
import dataclasses

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,        # MLA: kv heads == q heads after up-projection
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    act="swiglu",
    norm="rms",
    rope="std",
    rope_theta=10000.0,
    mla=MLAConfig(
        kv_lora_rank=512,
        rope_head_dim=64,
        v_head_dim=128,
        qk_nope_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        expert_ff=1408,
        n_shared=2,
        capacity_factor=1.25,
        first_dense=1,
        first_dense_ff=10944,   # DSv2-lite dense layer-1 intermediate size
    ),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=96, vocab=256,
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                      v_head_dim=16, qk_nope_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=96, n_shared=1,
                      # dropless at smoke scale: decode-vs-forward tests
                      # need no capacity truncation
                      capacity_factor=8.0, first_dense=1, first_dense_ff=128))
