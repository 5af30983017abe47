"""Architecture + shape configuration schema for the framework."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"          # gqa | mla | none
    causal: bool = True             # False: encoder-only (hubert)
    parallel_block: bool = False    # command-r style parallel attn+mlp
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()     # qwen2-vl
    window: int = 0                 # sliding-window size for "wattn" blocks
    kv_replicate_to: int = 0        # decode: replicate KV heads up to the
                                    # model-axis size so the cache head-shards
                                    # and attention is device-local (§Perf)

    # MLA (deepseek-v2)
    kv_lora: int = 0
    q_lora: int = 0
    nope_head_dim: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False        # decode: weight-absorbed latent attention

    # MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    expert_dff: int = 0
    shared_dff: int = 0
    first_dense: int = 0            # leading dense layers (deepseek-v2: 1)
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"         # gspmd (baseline) | shard_map (EP, §Perf)

    # recurrent families
    block_pattern: tuple[str, ...] = ()      # e.g. ("rglru","rglru","wattn")
    rnn_width: int = 0
    conv_width: int = 4
    rwkv_head_size: int = 64

    # frontend stubs
    frontend: str = "tokens"        # tokens | frames (audio stub)

    # numerics / compile shape
    act: str = "swiglu"             # swiglu | geglu
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"             # none | dots | full
    grad_accum: int = 1             # microbatches per step (memory §Perf)
    fsdp: bool = False
    logits_chunk: int = 512
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind[0] == "gqa" or kind[0] == "wattn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            elif kind[0] == "mla":
                qk = self.nope_head_dim + self.rope_head_dim
                total += d * (self.kv_lora + self.rope_head_dim)
                total += self.kv_lora * self.n_heads * (self.nope_head_dim
                                                        + self.v_head_dim)
                if self.q_lora:
                    total += d * self.q_lora + self.q_lora * self.n_heads * qk
                else:
                    total += d * self.n_heads * qk
                total += self.n_heads * self.v_head_dim * d
            elif kind[0] == "rwkv":
                total += 4 * d * d + d * 64 + 64 * d + 2 * d
            elif kind[0] == "rglru":
                w = self.rnn_width
                total += 2 * d * w + 2 * w * w + w * d + self.conv_width * w
            if kind[1] == "mlp":
                total += 3 * d * self.d_ff
            elif kind[1] == "moe":
                total += d * self.n_experts
                total += self.n_experts * 3 * d * self.expert_dff
                total += 3 * d * (self.shared_dff or 0)
            elif kind[1] == "rwkv_cm":
                total += 2 * d * self.d_ff + d * d
        return total

    def active_params(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        dense_like = dataclasses.replace(
            self, n_experts=0, top_k=0,
            d_ff=self.d_ff if self.first_dense else 1)
        total = dense_like.n_params()
        moe_layers = self.n_layers - self.first_dense
        total -= moe_layers * 3 * d * dense_like.d_ff  # remove placeholder mlp
        total += moe_layers * (self.top_k * 3 * d * self.expert_dff
                               + 3 * d * (self.shared_dff or 0)
                               + d * self.n_experts)
        return total

    def layer_kind(self, i: int) -> tuple[str, str]:
        """(mixer, mlp) kind of layer i."""
        if self.family == "ssm":
            return ("rwkv", "rwkv_cm")
        if self.block_pattern:
            mix = self.block_pattern[i % len(self.block_pattern)]
            return (mix, "mlp")
        mix = self.attn_type
        if self.n_experts and i >= self.first_dense:
            return (mix, "moe")
        return (mix, "mlp")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
