"""whisper-small [audio]: enc-dec, conv frontend stubbed to precomputed
frame embeddings. 12L(dec) d=768 12H (kv=12 ⇒ MHA) d_ff=3072 vocab=51865.
[arXiv:2212.04356]"""
import dataclasses

from .base import ArchConfig, XATTN

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="relu2",          # whisper uses GELU MLP; relu2 slot reused → see note
    norm="ln",
    rope="none",
    abs_pos=True,         # learned absolute positions
    pattern=(XATTN,),
    n_enc_layers=12,
    enc_len=1500,          # 30 s of audio at 50 Hz after the conv stub
)
# NOTE: whisper's MLP is GELU (non-gated). We model it as the non-gated
# 2-matrix MLP path ("relu2" kind uses square-relu; whisper uses "gelu").
CONFIG = dataclasses.replace(CONFIG, act="gelu")


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, enc_len=16)
