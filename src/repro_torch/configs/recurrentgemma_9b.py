"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]: RG-LRU + local attention,
pattern (rec, rec, attn) = 2:1; MQA (kv=1) with a 2048 sliding window. The
hybrid arch: runs long_500k via recurrent state + ring-buffer window cache."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "wattn"), window=2048,
    rnn_width=4096, conv_width=4, act="geglu",
    fsdp=True, remat="full",
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
    head_dim=16, block_pattern=("rglru", "rglru", "wattn"), window=16,
    rnn_width=64, conv_width=4, act="geglu", remat="none", logits_chunk=16,
)
