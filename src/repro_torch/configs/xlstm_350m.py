"""xlstm-350m [ssm]: mLSTM + sLSTM blocks at 7:1 (xLSTM[7:1]), no FFN —
blocks carry their own projections. 24L d=1024 4H vocab=50304.
[arXiv:2405.04517]"""
import dataclasses

from .base import ArchConfig, MLSTM, SLSTM

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                       # blocks are self-contained
    vocab=50304,
    act="swiglu",
    norm="ln",
    rope="none",
    pattern=(MLSTM,) * 7 + (SLSTM,),   # 7:1 → 21 mLSTM + 3 sLSTM over 24L
    conv_width=4,
    expand=2.0,                   # mLSTM pf=2 inner width
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, vocab=256,
        pattern=(MLSTM,) * 3 + (SLSTM,))
