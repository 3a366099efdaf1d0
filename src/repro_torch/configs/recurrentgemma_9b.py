"""recurrentgemma-9b [hybrid]: Griffin — RG-LRU blocks + local attention
at 1:2 (two recurrent per one local-attn), MQA kv=1, window 2048.
38L d=4096 16H d_ff=12288 vocab=256000. [arXiv:2402.19427]"""
import dataclasses

from .base import ArchConfig, LOCAL, RGLRU

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    act="geglu",
    norm="rms",
    rope="std",
    rope_theta=10000.0,
    pattern=(RGLRU, RGLRU, LOCAL),   # ×12 = 36
    pattern_tail=(RGLRU, RGLRU),     # + 2 → 38
    local_window=2048,
    conv_width=4,
    expand=1.0,                      # rg-lru width == d_model (9b uses 4096)
    attn_logit_softcap=0.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=192, vocab=512, pattern=(RGLRU, RGLRU, LOCAL), pattern_tail=(),
        local_window=16)
