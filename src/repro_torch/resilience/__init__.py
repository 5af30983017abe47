"""Typed failures of the port's serving layer (``errors``). Circuit
breakers and fault injection are a later slice (``ROADMAP.md`` queue 1,
item 7)."""
from .errors import MergeFailedError, QueueFullError, ResilienceError

__all__ = ["MergeFailedError", "QueueFullError", "ResilienceError"]
