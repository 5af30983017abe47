"""HuBERT X-Large [arXiv:2106.07447]: encoder-only (bidirectional) audio
backbone. The conv waveform frontend is a STUB: input_specs() provides
precomputed frame embeddings [B, T, d_model]; the train objective is
masked-frame cluster prediction over the 504-unit codebook (vocab=504, not
divisible by the model axis -> the resolver replicates the head, by design).
No decode shapes (encoder-only)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    causal=False, frontend="frames", act="geglu",
    remat="full",
)

SMOKE = ArchConfig(
    name="hubert-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=40,
    causal=False, frontend="frames", act="geglu", remat="none",
    logits_chunk=16,
)
