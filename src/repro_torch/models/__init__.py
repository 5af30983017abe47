"""The LM-family model (dense attention, MLA, the MoE) and its serving
steps (the port of ``repro.models``)."""
from .lm import Model, init_cache

__all__ = ["Model", "init_cache"]
