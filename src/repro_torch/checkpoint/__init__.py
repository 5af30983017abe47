"""The PLEX-indexed checkpoint store and its manager (the port of
``repro.checkpoint``): the reference's file format, byte for byte."""
from .manager import CheckpointManager
from .store import load_pytree, read_tensor, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "read_tensor", "save_pytree"]
