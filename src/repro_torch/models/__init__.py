"""The LM-family model of the dense-attention architectures and its
serving steps (the port of ``repro.models``)."""
from .lm import Model, init_cache

__all__ = ["Model", "init_cache"]
