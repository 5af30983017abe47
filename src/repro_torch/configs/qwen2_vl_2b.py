"""Qwen2-VL-2B [arXiv:2409.12191; hf]: M-RoPE decoder backbone. The vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings / text token ids; M-RoPE position streams default to the
text case (t=h=w)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    mrope_sections=(16, 24, 24),  # t/h/w bands over head_dim//2 = 64
    rope_theta=1e6,
    remat="full",
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, mrope_sections=(2, 3, 3), remat="none", logits_chunk=16,
)
