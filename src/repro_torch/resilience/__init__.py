"""Resilience layer of the port: fault injection, circuit breakers, typed
failures (the port's copy of ``repro.resilience``).

* ``faults``   — the deterministic, seedable fault-injection registry, its
  named points compiled into the backend dispatch, WAL/manifest and
  snapshot-mapping paths and the service's merges;
* ``breakers`` — per-backend circuit breakers (closed / open / half-open
  single-probe) behind ``PlexService``'s fallback chain
  (``cuda`` -> ``torch`` -> ``numpy``): a failed dispatch degrades to the
  next backend with the same lookup semantics, slower, never wrong;
* ``errors``   — the typed failure vocabulary of the degraded path.

Nothing here imports torch or the kernels.
"""
from .breakers import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .errors import (BackendUnavailableError, MergeFailedError,
                     NoServableGenerationError, PartitionLoadError,
                     QueueFullError, ResilienceError)
from .faults import (FAULTS, INJECTION_POINTS, FaultRegistry, InjectedFault,
                     POINT_BACKEND_DISPATCH, POINT_BACKEND_FACTORY,
                     POINT_MANIFEST_COMMIT, POINT_MERGE_BUILD,
                     POINT_PARTITION_LOAD, POINT_SNAPSHOT_MAP,
                     POINT_WAL_APPEND, POINT_WAL_FSYNC, Scenario, always,
                     fail_n, fail_once, fire, injected, intermittent)

__all__ = [
    "BackendUnavailableError", "CLOSED", "CircuitBreaker", "FAULTS",
    "FaultRegistry", "HALF_OPEN", "INJECTION_POINTS", "InjectedFault",
    "MergeFailedError", "NoServableGenerationError", "OPEN",
    "POINT_BACKEND_DISPATCH", "POINT_BACKEND_FACTORY",
    "POINT_MANIFEST_COMMIT", "POINT_MERGE_BUILD", "POINT_PARTITION_LOAD",
    "POINT_SNAPSHOT_MAP", "POINT_WAL_APPEND", "POINT_WAL_FSYNC",
    "PartitionLoadError", "QueueFullError", "ResilienceError", "Scenario",
    "always", "fail_n", "fail_once", "fire", "injected", "intermittent",
]
