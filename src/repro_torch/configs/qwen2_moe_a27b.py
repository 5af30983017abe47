"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4
plus a 4x-wide shared expert block."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, n_shared=4, top_k=4, expert_dff=1408,
    shared_dff=5632,              # 4 shared experts fused (4 x 1408)
    fsdp=True, remat="full",
)

SMOKE = ArchConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
    n_experts=6, n_shared=2, top_k=2, expert_dff=32, shared_dff=64,
    remat="none", logits_chunk=16,
)
