"""Phi-3-mini 3.8B [arXiv:2404.14219]: dense RoPE+SwiGLU GQA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    remat="full",
)

SMOKE = ArchConfig(
    name="phi3-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    remat="none", logits_chunk=16,
)
