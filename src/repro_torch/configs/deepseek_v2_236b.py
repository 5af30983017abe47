"""DeepSeek-V2 236B [arXiv:2405.04434; hf]: MLA (kv_lora=512) + 160-expert
top-6 MoE with 2 shared experts; first layer dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                   # dense layer-0 MLP (HF intermediate_size)
    vocab=102400,
    attn_type="mla", q_lora=1536, kv_lora=512,
    nope_head_dim=128, rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared=2, top_k=6, expert_dff=1536,
    shared_dff=2 * 1536, first_dense=1,
    fsdp=True, remat="full",
)

SMOKE = ArchConfig(
    name="deepseek-v2-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    attn_type="mla", q_lora=48, kv_lora=32,
    nope_head_dim=16, rope_head_dim=8, v_head_dim=16,
    n_experts=8, n_shared=2, top_k=2, expert_dff=32, shared_dff=64,
    first_dense=1, remat="none", logits_chunk=16,
)
