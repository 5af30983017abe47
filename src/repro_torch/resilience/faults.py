"""Deterministic, seedable fault-injection registry.

Chaos testing is only useful when a failure is *reproducible*: the same
scenario armed at the same point must trip on the same calls every run.
The registry holds named **injection points** — call sites the production
code marks with ``fire(point, **ctx)`` — and **scenarios** armed against
them with ``inject(point, scenario)``. An unarmed registry is a no-op
(one dict lookup per fire; the serving hot path pays nothing measurable),
so the hooks stay compiled into the real code paths rather than living in
a test-only fork of them.

Scenarios are pure counters/seeded RNG state, never wall clock:

* ``fail_once()``   — trip on the first matching call, then pass forever.
* ``fail_n(n)``     — trip on the first ``n`` matching calls.
* ``always()``      — trip on every matching call until cleared.
* ``intermittent(p, seed)`` — trip each matching call with probability
  ``p`` from a ``seed``-determined stream: given the same call order, the
  exact same calls trip on every run.

``**match`` keyword filters restrict a scenario to calls whose ``fire``
context matches (e.g. ``fail_once(backend="cuda")`` trips only the kernel
backend's dispatches). Trips raise ``exc`` (default ``InjectedFault``) and are
counted per point (``trips``), so tests can assert a fault actually fired
and was *handled*, not silently routed around.

The port's copy of ``repro.resilience.faults``: the point names are the
reference's letter for letter, so a chaos script arms either package with
the same strings. Injection points wired into the port's serving stack
(the fault matrix, ``tests/test_torch_resilience.py``):

======================  ====================================================
point                   fires
======================  ====================================================
POINT_BACKEND_FACTORY   building a stacked/index impl (registry factories)
POINT_BACKEND_DISPATCH  every micro-batch dispatch of a built impl, and the
                        host (numpy) per-shard lookup path; ctx ``backend``
POINT_SNAPSHOT_MAP      ``persist.format.load_snapshot`` plane mapping;
                        ctx ``gen_dir``
POINT_WAL_APPEND        ``WriteAheadLog.append`` before the record write
POINT_WAL_FSYNC         ``WriteAheadLog.append`` before the fsync
POINT_MANIFEST_COMMIT   ``persist.manifest.write_manifest`` before the
                        atomic rename (nothing committed when it trips)
POINT_PARTITION_LOAD    one slot's partition load / slab build
                        (``distrib.partition``, ``distrib.loader``)
POINT_MERGE_BUILD       ``PlexService._merge_once`` before the snapshot
                        rebuild
POINT_BUILD_SHARD       sharded build (``core.parallel_build``), in the
                        parent, as each shard's built PLEX is collected
POINT_MERGE_WORKER      the background merge worker thread, at the top of
                        each wakeup — an uncaught trip here kills the
                        worker itself, the "worker death" chaos case
======================  ====================================================

The module-level ``FAULTS`` registry is what the production hooks fire
through; tests arm it directly or via the ``injected`` context manager
(which guarantees cleanup, so a failing test never leaks an armed fault
into the next one).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator

import numpy as np

__all__ = [
    "FAULTS", "FaultRegistry", "InjectedFault", "Scenario",
    "INJECTION_POINTS", "POINT_BACKEND_DISPATCH", "POINT_BACKEND_FACTORY",
    "POINT_BUILD_SHARD", "POINT_MANIFEST_COMMIT", "POINT_MERGE_BUILD",
    "POINT_MERGE_WORKER", "POINT_PARTITION_LOAD", "POINT_SNAPSHOT_MAP",
    "POINT_WAL_APPEND", "POINT_WAL_FSYNC",
    "always", "fail_n", "fail_once", "fire", "injected", "intermittent",
]

POINT_BACKEND_FACTORY = "backend.factory"
POINT_BACKEND_DISPATCH = "backend.dispatch"
POINT_SNAPSHOT_MAP = "persist.snapshot.map"
POINT_WAL_APPEND = "persist.wal.append"
POINT_WAL_FSYNC = "persist.wal.fsync"
POINT_MANIFEST_COMMIT = "persist.manifest.commit"
POINT_PARTITION_LOAD = "distrib.partition.load"
POINT_MERGE_BUILD = "serving.merge.build"
POINT_BUILD_SHARD = "core.build.shard"
POINT_MERGE_WORKER = "serving.merge.worker"

INJECTION_POINTS = (
    POINT_BACKEND_FACTORY, POINT_BACKEND_DISPATCH, POINT_SNAPSHOT_MAP,
    POINT_WAL_APPEND, POINT_WAL_FSYNC, POINT_MANIFEST_COMMIT,
    POINT_PARTITION_LOAD, POINT_MERGE_BUILD, POINT_BUILD_SHARD,
    POINT_MERGE_WORKER,
)


class InjectedFault(RuntimeError):
    """The default exception an armed scenario raises. Deliberately a
    plain ``RuntimeError`` subclass: the production handlers must treat it
    exactly like a real dispatch/IO failure, never special-case it."""


@dataclasses.dataclass
class Scenario:
    """One armed failure pattern. ``remaining`` counts trips left
    (``math.inf`` for ``always``); ``p``/``rng`` drive the intermittent
    mode; ``match`` filters on the fire context."""
    kind: str
    remaining: float = 1.0
    p: float = 1.0
    rng: np.random.Generator | None = None
    exc: type[BaseException] = InjectedFault
    match: dict[str, Any] = dataclasses.field(default_factory=dict)

    def matches(self, ctx: dict[str, Any]) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())

    def trip(self) -> bool:
        """Advance the scenario's deterministic state by one matching
        call; True when this call must fail."""
        if self.remaining <= 0:
            return False
        if self.rng is not None and float(self.rng.random()) >= self.p:
            return False
        self.remaining -= 1
        return True


def fail_once(exc: type[BaseException] = InjectedFault, **match) -> Scenario:
    """Trip the first matching call, then pass."""
    return Scenario(kind="fail_once", remaining=1, exc=exc, match=match)


def fail_n(n: int, exc: type[BaseException] = InjectedFault,
           **match) -> Scenario:
    """Trip the first ``n`` matching calls, then pass."""
    return Scenario(kind="fail_n", remaining=float(n), exc=exc, match=match)


def always(exc: type[BaseException] = InjectedFault, **match) -> Scenario:
    """Trip every matching call until the scenario is cleared."""
    return Scenario(kind="always", remaining=math.inf, exc=exc, match=match)


def intermittent(p: float, seed: int,
                 exc: type[BaseException] = InjectedFault,
                 **match) -> Scenario:
    """Trip each matching call with probability ``p`` from a seeded
    stream — the same calls trip on every run with the same call order."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p={p} outside [0, 1]")
    return Scenario(kind="intermittent", remaining=math.inf, p=float(p),
                    rng=np.random.default_rng(seed), exc=exc, match=match)


class FaultRegistry:
    """Armed scenarios per injection point + trip accounting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, list[Scenario]] = {}
        self._trips: dict[str, int] = {}
        self._armed = False          # lock-free fast-path gate for fire()

    def inject(self, point: str, scenario: Scenario) -> Scenario:
        """Arm ``scenario`` at ``point``; returns it (handle for tests)."""
        with self._lock:
            self._points.setdefault(point, []).append(scenario)
            self._armed = True
        return scenario

    def clear(self, point: str | None = None) -> None:
        """Disarm one point (or everything) and keep the trip counters."""
        with self._lock:
            if point is None:
                self._points.clear()
            else:
                self._points.pop(point, None)
            self._armed = bool(self._points)

    def reset(self) -> None:
        """Disarm everything and zero the trip counters."""
        with self._lock:
            self._points.clear()
            self._trips.clear()
            self._armed = False

    def trips(self, point: str) -> int:
        """How many times ``point`` has actually raised."""
        return self._trips.get(point, 0)

    def active(self) -> dict[str, int]:
        """Armed points -> number of live scenarios (for ``health()``)."""
        with self._lock:
            return {p: len(s) for p, s in self._points.items() if s}

    def snapshot(self) -> dict:
        """Armed points + lifetime trip counts in one locked view — the
        ``armed_faults`` payload of an incident bundle (a post-mortem
        must show whether a drill, not production, caused the failure)."""
        with self._lock:
            return {
                "active": {p: len(s) for p, s in self._points.items() if s},
                "trips": dict(self._trips),
            }

    def fire(self, point: str, **ctx) -> None:
        """Production-side hook: raise iff an armed scenario trips.

        The unarmed fast path is one attribute read — safe to leave in
        dispatch loops. Exhausted scenarios (``remaining`` hits 0 with no
        trips left) are pruned in place."""
        if not self._armed:
            return
        with self._lock:
            scens = self._points.get(point)
            if not scens:
                return
            for s in scens:
                if s.matches(ctx) and s.trip():
                    if s.remaining <= 0:
                        scens.remove(s)
                        self._armed = any(self._points.values())
                    self._trips[point] = self._trips.get(point, 0) + 1
                    exc = s.exc
                    break
            else:
                return
        detail = f" ({', '.join(f'{k}={v!r}' for k, v in ctx.items())})" \
            if ctx else ""
        raise exc(f"injected fault at {point}{detail}")

    @contextlib.contextmanager
    def injected(self, point: str, scenario: Scenario) -> Iterator[Scenario]:
        """Arm for the duration of a with-block; always disarms the exact
        scenario on exit, even when the block raises."""
        self.inject(point, scenario)
        try:
            yield scenario
        finally:
            with self._lock:
                scens = self._points.get(point)
                if scens and scenario in scens:
                    scens.remove(scenario)
                self._armed = any(self._points.values())


#: The process-wide registry every production hook fires through.
FAULTS = FaultRegistry()
fire = FAULTS.fire
injected = FAULTS.injected
