"""Architecture + shape configuration schema.

Every assigned architecture is a frozen ``ArchConfig``; the four shape
cells are ``ShapeConfig``s. ``layout()`` expresses the layer stack as
(repeating unit, count) pairs so heterogeneous stacks (Griffin 1:2,
xLSTM 7:1, DeepSeek first-dense) scan over homogeneous super-blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# layer kinds understood by models/blocks.py
ATTN = "attn"            # causal self-attention + MLP
ATTN_BIDIR = "attn_bidir"  # bidirectional (encoder) self-attention + MLP
XATTN = "xattn"          # causal self-attn + cross-attn + MLP (decoder of enc-dec)
LOCAL = "local"          # sliding-window causal attention + MLP
MLSTM = "mlstm"          # xLSTM matrix-memory block (self-contained)
SLSTM = "slstm"          # xLSTM scalar-memory block (self-contained)
RGLRU = "rglru"          # Griffin RG-LRU recurrent block + MLP


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    dense_residual_ff: int = 0  # parallel dense FFN (Arctic-style dense+MoE)
    capacity_factor: float = 1.25
    first_dense: int = 0        # leading layers that use a dense FFN instead
    first_dense_ff: int = 0

    def experts_of(self, shard: int) -> range:
        """The routed experts that model shard ``shard`` holds: all of
        them (a whole model; :class:`ShardMoEConfig` is a shard's)."""
        return range(self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShardMoEConfig(MoEConfig):
    """A tensor-parallel model shard's view of :class:`MoEConfig`
    (``distributed.tensor_parallel.shard_config``): ``n_experts`` stays the
    model's, which the router needs, and the routed experts are split over
    ``expert_shards`` shards, shard m holding ``[m·E/t, (m+1)·E/t)``."""
    expert_shards: int = 1

    def experts_of(self, shard: int) -> range:
        n = self.n_experts // self.expert_shards
        return range(shard * n, (shard + 1) * n)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    act: str = "swiglu"         # swiglu | geglu | relu2
    norm: str = "rms"           # rms | ln
    qk_norm: bool = False
    rope: str = "std"           # std | mrope | none
    abs_pos: bool = False       # learned absolute positions (whisper)
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    tie_embeddings: bool = False
    # hybrid stacks: repeating unit of layer kinds; () → all ATTN
    pattern: Tuple[str, ...] = ()
    pattern_tail: Tuple[str, ...] = ()   # remainder layers after the repeats
    local_window: int = 2048
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # enc-dec (whisper): encoder layers + fixed source length (frames)
    n_enc_layers: int = 0
    enc_len: int = 0
    # vlm stub: number of precomputed patch embeddings prepended
    n_vision_embeds: int = 0
    # ssm sizing
    conv_width: int = 4          # rglru/mlstm short conv
    expand: float = 1.0          # rnn width multiplier (Griffin uses 4/3)
    attn_logit_softcap: float = 0.0

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layout(self) -> Sequence[Tuple[Tuple[str, ...], int]]:
        """[(unit, repeats), ...] covering all n_layers, in order."""
        unit = self.pattern or (ATTN,)
        tail = self.pattern_tail
        if self.moe and self.moe.first_dense:
            head = (unit[0] + "_dense",) * self.moe.first_dense
            body_layers = self.n_layers - self.moe.first_dense - len(tail)
            assert body_layers % len(unit) == 0, (self.name, body_layers, unit)
            out = [(head, 1), (unit, body_layers // len(unit))]
        else:
            body_layers = self.n_layers - len(tail)
            assert body_layers % len(unit) == 0, (self.name, body_layers, unit)
            out = [(unit, body_layers // len(unit))]
        if tail:
            out.append((tail, 1))
        return out

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, dh = self.d_model, self.dh
        kv = self.n_kv_heads
        att = d * (self.n_heads * dh) + 2 * d * kv * dh + (self.n_heads * dh) * d
        if self.mla:
            c = self.mla
            att = (d * self.n_heads * (c.qk_nope_head_dim + c.rope_head_dim)
                   + d * (c.kv_lora_rank + c.rope_head_dim)
                   + c.kv_lora_rank * self.n_heads * (c.qk_nope_head_dim + c.v_head_dim)
                   + self.n_heads * c.v_head_dim * d)
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        per_kind = {}
        per_kind[ATTN] = att + mlp_mult * d * self.d_ff
        per_kind[ATTN_BIDIR] = per_kind[ATTN]
        per_kind[XATTN] = 2 * att + mlp_mult * d * self.d_ff
        per_kind[LOCAL] = per_kind[ATTN]
        rnn_d = int(d * self.expand)
        per_kind[RGLRU] = 2 * d * rnn_d + rnn_d * d + 2 * rnn_d + mlp_mult * d * self.d_ff
        per_kind[MLSTM] = 2 * d * 2 * d + 2 * d * d + 3 * (2 * d) * 3  # qkv on 2d inner
        per_kind[SLSTM] = 4 * d * d + 4 * (d // max(self.n_heads, 1)) * d + 2 * d * int(d * 4 / 3)
        if self.moe:
            mo = self.moe
            moe_params = mo.n_experts * mlp_mult * d * mo.expert_ff
            moe_params += mo.n_shared * mlp_mult * d * mo.expert_ff
            moe_params += d * mo.n_experts
            if mo.dense_residual_ff:
                moe_params += mlp_mult * d * mo.dense_residual_ff
            per_kind[ATTN] = att + moe_params
            per_kind[ATTN + "_dense"] = att + mlp_mult * d * (
                mo.first_dense_ff or self.d_ff)
        total = 0
        for unit, reps in self.layout():
            for kind in unit:
                base = kind.replace("_dense", "") if kind not in per_kind else kind
                total += per_kind[kind if kind in per_kind else base] * reps
        total += self.n_enc_layers * per_kind.get(ATTN_BIDIR, 0)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.moe:
            return self.param_count()
        mo = self.moe
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        inactive = (mo.n_experts - mo.top_k) * mlp_mult * self.d_model * mo.expert_ff
        n_moe_layers = self.n_layers - mo.first_dense
        return int(self.param_count() - inactive * n_moe_layers)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    # decode/long: KV cache length (context already processed)
    cache_len: int = 0


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 1, 128, "decode", cache_len=32768),
    "long_500k": ShapeConfig("long_500k", 1, 1, "decode", cache_len=524288),
}

# archs that may run long_500k (sub-quadratic serving memory/compute)
SUBQUADRATIC = ("xlstm-350m", "recurrentgemma-9b")


def runnable_cells(arch: "ArchConfig") -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.name in SUBQUADRATIC:
        cells.append("long_500k")
    return cells
