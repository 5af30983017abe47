"""Per-backend circuit breakers for the serving fallback chain.

A breaker wraps one backend's dispatch health. The contract mirrors the
classic three-state machine, tuned for a lookup path where *correctness
never degrades* (every fallback backend computes the identical answer, so
tripping a breaker costs latency, not wrongness):

* **closed** — normal serving. ``failure_threshold`` *consecutive*
  failures open it (a single success resets the count: transient blips
  under load never accumulate into an open).
* **open** — the backend is skipped outright, so a known-bad cuda/torch
  path stops eating a failed dispatch per lookup. After ``cooldown_s``
  the next ``allow()`` transitions to half-open.
* **half-open** — exactly one probe call is admitted (concurrent callers
  keep being refused, so a recovering backend is never stampeded). The
  probe's success closes the breaker; its failure re-opens it for a fresh
  cooldown.

``clock`` is injectable so tests drive the cooldown deterministically
instead of sleeping.

The port's copy of ``repro.resilience.breakers``. Each transition is a
``breaker.transition`` trace event and counts in ``METRICS``
(``breaker.<name>.to_<state>``); an open writes a ``breaker.open``
incident bundle when a manager is installed (``obs.incident``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from ..obs.incident import report as _report_incident
from ..obs.metrics import METRICS
from ..obs.trace import TRACE

__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

DEFAULT_FAILURE_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 30.0


class CircuitBreaker:
    """Consecutive-failure breaker with a single-probe half-open state."""

    def __init__(self, name: str, *,
                 failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.failures = 0            # lifetime totals (telemetry)
        self.successes = 0
        self.opens = 0               # closed/half-open -> open transitions
        self.last_error: BaseException | None = None

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        """State with the cooldown expiry folded in (lock held)."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            return HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """May a call go through right now?

        Closed: always. Open: no, until the cooldown elapses — then the
        breaker moves to half-open and admits exactly one probe; further
        calls are refused until the probe reports."""
        with self._lock:
            state = self._peek_state()
            if state == CLOSED:
                return True
            if state == HALF_OPEN:
                if self._state == OPEN:          # cooldown just elapsed
                    self._state = HALF_OPEN
                    self._probe_inflight = False
                if self._probe_inflight:
                    return False
                self._probe_inflight = True
                return True
            return False

    def _note_transition(self, frm: str, to: str) -> None:
        """Telemetry for a state change (called outside ``_lock``)."""
        if TRACE.enabled:
            TRACE.event("breaker.transition", breaker=self.name,
                        frm=frm, to=to)
        if METRICS.enabled:
            METRICS.counter(f"breaker.{self.name}.to_{to}").inc()
        if to == OPEN:
            _report_incident(
                "breaker.open",
                f"breaker {self.name!r} opened ({frm} -> open) after "
                f"{self.failures} lifetime failure(s)",
                breaker=self.name, frm=frm,
                last_error=repr(self.last_error)
                if self.last_error is not None else None)

    def record_success(self) -> None:
        with self._lock:
            self.successes += 1
            self._consecutive_failures = 0
            self._probe_inflight = False
            prev, self._state = self._state, CLOSED
        if prev != CLOSED:
            self._note_transition(prev, CLOSED)

    def record_failure(self, error: BaseException | None = None) -> None:
        opened_from = None
        with self._lock:
            self.failures += 1
            self.last_error = error
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh cooldown
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_inflight = False
                self.opens += 1
                opened_from = HALF_OPEN
            else:
                self._consecutive_failures += 1
                if self._state == CLOSED and \
                        self._consecutive_failures >= self.failure_threshold:
                    self._state = OPEN
                    self._opened_at = self._clock()
                    self.opens += 1
                    opened_from = CLOSED
        if opened_from is not None:
            self._note_transition(opened_from, OPEN)

    def snapshot(self) -> dict:
        """JSON-friendly state for ``PlexService.health()``."""
        with self._lock:
            state = self._peek_state()
            cooldown_left = 0.0
            if state != CLOSED:
                cooldown_left = max(
                    0.0, self.cooldown_s - (self._clock() - self._opened_at))
            return {
                "state": state,
                "consecutive_failures": self._consecutive_failures,
                "failures": self.failures,
                "successes": self.successes,
                "opens": self.opens,
                "cooldown_remaining_s": round(cooldown_left, 3),
                "last_error": repr(self.last_error)
                if self.last_error is not None else None,
            }

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        return (f"CircuitBreaker({self.name!r}, state={self.state}, "
                f"failures={self.failures})")
