"""The LM-family model (dense attention, MLA, the MoE, RWKV6, the RG-LRU,
the windowed-attention ring buffer, the frames and patch-embedding
frontends) and its train and serving steps (the port of ``repro.models``)."""
from .lm import Model, init_cache

__all__ = ["Model", "init_cache"]
