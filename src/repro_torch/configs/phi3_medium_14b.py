"""Phi-3-medium 14B [arXiv:2404.14219]: dense RoPE+SwiGLU GQA (kv=10)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352,
    fsdp=True, remat="full",
)

SMOKE = ArchConfig(
    name="phi3-medium-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    remat="none", logits_chunk=16,
)
