"""Minitron-4B [arXiv:2407.14679; hf]: width/depth-pruned Nemotron
(3072 d_model, 24 heads of 128, GQA kv=8, 256k vocab)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256000, head_dim=128,
    remat="full",
)

SMOKE = ArchConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, remat="none", logits_chunk=16,
)
