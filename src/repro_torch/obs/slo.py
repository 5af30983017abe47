"""Declarative SLOs evaluated with multi-window burn rates.

An :class:`SLOSpec` names one objective over the service ``health()``
dict — "p99 lookup latency stays under 50us", "the queue sheds less
than one query/s" — and the :class:`SLOWatchdog` evaluates every spec
against each observed health sample using the standard multi-window
burn-rate rule: an SLO is *breached* only when the error budget is
burning at ≥ ``burn_factor`` in **every** window (a short window so
pages are fast, a long window so a single bad sample can't page).
Breach transitions emit a ``slo.breach`` trace event (never sampled)
and an ``slo.<name>`` incident bundle; recovery is just the burn
dropping below the factor in the short window on a later sample.

The watchdog owns no thread: drive it by calling ``observe(health())``
from anywhere — in production that is one flight-recorder probe
(:func:`watch_service` wires it), in tests an injected clock steps
time deterministically.

Value kinds:

- ``level``  — the health field is an instantaneous value compared
  against ``bound`` directly (p99 ns, merge backlog age, WAL bytes).
- ``rate``   — the health field is a monotonic counter; the sample is
  its per-second delta between consecutive observations (fallbacks/s,
  backend errors/s, shed queries/s). Counter resets clamp to 0.

The port's own copy of ``repro.obs.slo``: ``default_slos``' bounds are
the reference's parameters, copied as they are.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

from .incident import report
from .recorder import RECORDER
from .trace import TRACE

__all__ = ["DEFAULT_WINDOWS", "SLOSpec", "SLOWatchdog", "default_slos",
           "watch_service"]

DEFAULT_WINDOWS = (60.0, 300.0)    # (page-fast, page-sure) seconds


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One objective over a path into the ``health()`` dict.

    ``budget`` is the tolerated bad fraction of samples per window
    (0.05 = 5% of samples may violate ``bound`` before burn = 1.0).
    """

    name: str
    path: tuple[str, ...]          # keys into health(), outermost first
    bound: float
    mode: str = "max"              # "max": value must stay <= bound;
    #                                "min": value must stay >= bound
    kind: str = "level"            # "level" | "rate" (counter delta/s)
    budget: float = 0.05
    windows: tuple[float, ...] = DEFAULT_WINDOWS
    burn_factor: float = 1.0

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError(f"SLOSpec {self.name!r}: mode {self.mode!r}")
        if self.kind not in ("level", "rate"):
            raise ValueError(f"SLOSpec {self.name!r}: kind {self.kind!r}")
        if not 0 < self.budget <= 1:
            raise ValueError(f"SLOSpec {self.name!r}: budget must be in "
                             f"(0, 1], got {self.budget}")
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError(f"SLOSpec {self.name!r}: bad windows "
                             f"{self.windows}")


def _resolve(health, path: tuple[str, ...]):
    cur = health
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    try:
        return float(cur)
    except (TypeError, ValueError):
        return None


def default_slos(*, lookup_p99_ns: float = 50_000.0,
                 fallback_per_s: float = 1.0,
                 errors_per_s: float = 1.0,
                 shed_per_s: float = 1.0,
                 merge_backlog_s: float = 60.0,
                 wal_bytes: float = 64 * 2 ** 20,
                 windows: tuple[float, ...] = DEFAULT_WINDOWS
                 ) -> tuple[SLOSpec, ...]:
    """The serving tier's stock objectives (bounds are the dials)."""
    return (
        # p99 per-key lookup latency, from the live registry histogram
        SLOSpec("lookup_p99_ns",
                ("metrics", "registry", "histograms",
                 "serve.lookup_ns_per_key", "p99"),
                lookup_p99_ns, windows=windows),
        # degraded-path pressure: fallback lookups + backend errors per s
        SLOSpec("fallback_rate", ("fallback_lookups",), fallback_per_s,
                kind="rate", windows=windows),
        SLOSpec("error_rate", ("backend_failures",), errors_per_s,
                kind="rate", windows=windows),
        # admission control: shed queries per second
        SLOSpec("shed_rate", ("shed_queries",), shed_per_s,
                kind="rate", windows=windows),
        # write path: age of the oldest over-threshold unmerged delta
        SLOSpec("merge_backlog_s", ("merge_backlog_s",), merge_backlog_s,
                windows=windows),
        # recovery-replay bound: WAL bytes since the last rotation
        SLOSpec("wal_bytes", ("wal_bytes",), wal_bytes, windows=windows),
    )


class SLOWatchdog:
    """Evaluates a set of :class:`SLOSpec` against health samples."""

    def __init__(self, specs=None, *, clock=time.monotonic,
                 maxlen: int = 4096):
        self.specs = tuple(specs) if specs is not None else default_slos()
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._clock = clock
        self._lock = threading.Lock()
        self._samples = {s.name: collections.deque(maxlen=maxlen)
                         for s in self.specs}    # (ts, value, bad)
        self._prev: dict[str, tuple[float, float]] = {}   # rate memory
        self._state = {s.name: "ok" for s in self.specs}
        self._last_value: dict[str, float] = {}
        self.breaches = {s.name: 0 for s in self.specs}

    # -- evaluation ----------------------------------------------------------
    def observe(self, health: dict) -> dict:
        """Fold one health sample into every spec's window; emit breach
        events/incidents on ok->breach transitions. Returns status()."""
        now = self._clock()
        transitions: list[tuple[SLOSpec, float]] = []
        with self._lock:
            for s in self.specs:
                raw = _resolve(health, s.path)
                if raw is None:
                    continue       # field absent (e.g. obs disabled)
                if s.kind == "rate":
                    prev = self._prev.get(s.name)
                    self._prev[s.name] = (now, raw)
                    if prev is None or now <= prev[0]:
                        continue   # need two points for a rate
                    value = max(0.0, (raw - prev[1]) / (now - prev[0]))
                else:
                    value = raw
                bad = value > s.bound if s.mode == "max" else value < s.bound
                self._samples[s.name].append((now, value, bad))
                self._last_value[s.name] = value
                state = ("breach" if all(
                    b >= s.burn_factor and n > 0
                    for b, n in (self._burn(s, w, now) for w in s.windows))
                    else "ok")
                if state != self._state[s.name]:
                    self._state[s.name] = state
                    if state == "breach":
                        self.breaches[s.name] += 1
                        transitions.append((s, value))
            status = self._status_locked()
        for s, value in transitions:
            TRACE.event("slo.breach", slo=s.name, value=value,
                        bound=s.bound, mode=s.mode, kind=s.kind)
            report(f"slo.{s.name}",
                   f"SLO {s.name} burn >= {s.burn_factor:g}x in all "
                   f"windows {s.windows} (last value {value:g}, bound "
                   f"{s.bound:g})",
                   health=health, slo=s.name, value=value, bound=s.bound)
        return status

    def _burn(self, s: SLOSpec, window: float, now: float):
        """(burn rate, sample count) over the trailing ``window``."""
        lo = now - window
        tot = bad = 0
        for ts, _, b in reversed(self._samples[s.name]):
            if ts < lo:
                break
            tot += 1
            bad += b
        if tot == 0:
            return 0.0, 0
        return (bad / tot) / s.budget, tot

    # -- inspection ----------------------------------------------------------
    def _status_locked(self) -> dict:
        now = self._clock()
        out = {}
        for s in self.specs:
            burns = {f"{w:g}s": round(self._burn(s, w, now)[0], 4)
                     for w in s.windows}
            st = {"state": self._state[s.name], "bound": s.bound,
                  "mode": s.mode, "kind": s.kind, "budget": s.budget,
                  "burn": burns, "breaches": self.breaches[s.name]}
            if s.name in self._last_value:
                st["value"] = round(self._last_value[s.name], 4)
            out[s.name] = st
        return out

    def status(self) -> dict:
        """Per-SLO state dict — the ``health()["slo"]`` section."""
        with self._lock:
            return self._status_locked()


def watch_service(svc, specs=None, *, recorder=RECORDER, watchdog=None,
                  **slo_kw):
    """Wire a service to the armed flight recorder's sampler: build (or
    take) a watchdog, attach it so ``health()`` grows the ``"slo"``
    section, and register a sampler probe that evaluates every spec
    against a fresh ``health()`` each tick. Returns the watchdog (its
    probe can be dropped later via ``recorder.remove_probe``)."""
    wd = watchdog if watchdog is not None \
        else SLOWatchdog(specs if specs is not None
                         else default_slos(**slo_kw))
    svc.attach_slo(wd)
    recorder.add_probe(lambda: wd.observe(svc.health()))
    return wd
