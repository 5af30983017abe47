"""Typed failure vocabulary for the resilience layer (the port's copy of
``repro.resilience.errors``; ``PartitionLoadError`` names the slot whose
slab failed to load, ``distrib``).

The fault-matrix acceptance contract is "parity or a typed error, never a
wrong answer, never a hang" — these are the types. Every degraded-path
decision the serving stack makes surfaces as one of them (or as the
original cause chained behind one), so callers and chaos tests can assert
on failure *kind* instead of string-matching messages.
"""
from __future__ import annotations

__all__ = [
    "BackendUnavailableError", "MergeFailedError",
    "NoServableGenerationError", "PartitionLoadError", "QueueFullError",
    "ResilienceError",
]


class ResilienceError(RuntimeError):
    """Base of every typed degraded-path failure."""


class BackendUnavailableError(ResilienceError):
    """Every backend in the fallback chain failed or has an open circuit
    breaker — the one way a lookup is allowed to fail."""

    def __init__(self, chain, last_error=None):
        self.chain = tuple(chain)
        self.last_error = last_error
        super().__init__(
            f"no serving backend available (chain {list(self.chain)}; "
            f"last error: {last_error!r})")


class MergeFailedError(ResilienceError):
    """An explicit ``merge()`` (or its durable commit) threw. The live
    (snapshot, delta, router) state is untouched; the delta stays buffered
    and a later merge retries."""


class PartitionLoadError(ResilienceError):
    """One device's partition load / slab build failed. ``device_index``
    is the plan-space index of the failed device, so the caller can drop
    exactly that device and re-plan onto the survivors."""

    def __init__(self, device_index: int, device, cause: BaseException):
        self.device_index = int(device_index)
        self.device = device
        self.cause = cause
        super().__init__(
            f"device {device_index} ({device}) failed to load its "
            f"partition: {cause!r}")


class QueueFullError(ResilienceError):
    """Admission control rejected (or shed) queued work: the bounded
    submit queue was full. Carried by shed tickets' ``result()`` too."""


class NoServableGenerationError(ResilienceError):
    """A persisted store has generation directories but none of them —
    newest through oldest — passed validation; every candidate was
    quarantined. Distinct from ``FileNotFoundError`` (never published)."""

    def __init__(self, root, last_error=None):
        self.root = root
        self.last_error = last_error
        super().__init__(
            f"no servable generation under {root} "
            f"(last error: {last_error!r})")
