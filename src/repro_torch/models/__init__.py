"""The LM-family model (dense attention, MLA, the MoE, RWKV6, the RG-LRU
and the windowed-attention ring buffer) and its serving steps (the port of
``repro.models``)."""
from .lm import Model, init_cache

__all__ = ["Model", "init_cache"]
