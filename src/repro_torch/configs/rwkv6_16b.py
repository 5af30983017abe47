"""RWKV6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay; the only pure-SSM arch (runs the long_500k cell)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    attn_type="none", rwkv_head_size=64,
    remat="full",
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    attn_type="none", rwkv_head_size=16, remat="none", logits_chunk=16,
)
