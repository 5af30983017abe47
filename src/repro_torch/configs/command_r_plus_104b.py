"""Command R+ 104B [hf:CohereForAI]: dense GQA with parallel attn+MLP blocks,
no biases; the largest dense arch (FSDP on)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
    parallel_block=True, rope_theta=75e4,
    fsdp=True, remat="full",
)

SMOKE = ArchConfig(
    name="command-r-plus-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, parallel_block=True, remat="none", logits_chunk=16,
)
