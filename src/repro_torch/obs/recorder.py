"""Always-on flight recorder: sampled spans + a background series sampler.

Arm-on-demand telemetry is full-fidelity, but an operator only
has it when they remembered to turn it on *before* the incident. The
flight recorder is the production posture — cheap enough to leave armed
permanently, so the last minutes before any failure are always on disk
in the incident bundle:

- ``arm()`` enables the global ``METRICS``/``TRACE`` singletons, sets
  ``TRACE.sample_n`` so only 1-in-N root spans, each with everything
  inside it, pay the allocation+append cost (``event``s — breaker opens,
  SLO breaches — are never sampled), and
  clears ``METRICS.counted_dispatch`` so serving keeps the plain/cached
  kernels instead of the counted-dispatch planes — exact live hotness
  stays an opt-in full-fidelity drill, not a standing device tax.
- A daemon sampler thread wakes every ``interval_s`` and snapshots every
  registry instrument into bounded per-series time rings (counters and
  gauges as values, histograms as count/p50/p99), giving incident
  bundles *history* — "p99 was flat until 40s before the breaker
  opened" — where a registry snapshot alone gives one point.
- ``add_probe(fn)`` runs operator callbacks once per tick; the SLO
  watchdog (``obs.slo.watch_service``) rides this to evaluate burn
  rates against a fresh ``health()`` without its own thread.

Cost contract (asserted by ``python -m repro_torch.launch.observe`` and
by ``chip_smoke.py``'s ``observe`` phase on the card): the sampled hook
path stays within the serve overhead budget, and one sampler tick stays a
small fraction of its interval. Everything the sampler does is contained
— a failing probe or a torn instrument read never takes down serving,
because telemetry is best-effort by contract.

The port's own copy of ``repro.obs.recorder``. Cleared
``counted_dispatch`` makes an armed service serve through K1's uncounted
variant. The sampler thread never touches CUDA: it reads the registry and
calls probes, and the service's ``health()`` is host-only.
"""
from __future__ import annotations

import collections
import threading
import time

from .metrics import METRICS, MetricsRegistry
from .trace import TRACE, Tracer

__all__ = ["DEFAULT_INTERVAL_S", "DEFAULT_SPAN_SAMPLE", "FlightRecorder",
           "RECORDER"]

DEFAULT_INTERVAL_S = 1.0           # sampler wake period
DEFAULT_SPAN_SAMPLE = 8            # keep 1-in-8 root spans when armed
DEFAULT_SERIES_MAXLEN = 512        # points kept per time series
DEFAULT_MAX_SERIES = 256           # distinct series before dropping new ones


class FlightRecorder:
    """Bounded-memory background sampler over the metrics registry.

    All mutation is serialised on one lock; the sampler thread is a
    daemon so an armed recorder never blocks interpreter exit. ``tick``
    is public so tests (and the overhead drill) can drive one sampler
    pass deterministically without the thread.
    """

    def __init__(self, *, registry: MetricsRegistry = METRICS,
                 tracer: Tracer = TRACE,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 span_sample: int = DEFAULT_SPAN_SAMPLE,
                 series_maxlen: int = DEFAULT_SERIES_MAXLEN,
                 max_series: int = DEFAULT_MAX_SERIES):
        self._registry = registry
        self._tracer = tracer
        self.interval_s = float(interval_s)
        self.span_sample = int(span_sample)
        self.series_maxlen = int(series_maxlen)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._series: dict[str, collections.deque] = {}
        self._probes: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.dropped_series = 0
        self.last_tick_s = 0.0     # duration of the most recent tick

    # -- lifecycle -----------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def arm(self, *, interval_s: float | None = None,
            span_sample: int | None = None) -> None:
        """Enable observability in sampled mode and start the sampler.

        Idempotent: re-arming an armed recorder just updates the dials.
        """
        with self._lock:
            if interval_s is not None:
                self.interval_s = float(interval_s)
            if span_sample is not None:
                self.span_sample = int(span_sample)
            self._registry.enable()
            # sampled posture: counters/histograms/sampled spans, but NOT
            # the counted-dispatch kernels — exact live hotness is the
            # full-fidelity drill's job (enable_observability), not a
            # standing per-block device tax
            self._registry.counted_dispatch = False
            self._tracer.sample_n = max(int(self.span_sample), 1)
            self._tracer.enable()
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._main, name="plex-flight-recorder",
                    daemon=True)
                self._thread.start()

    def disarm(self) -> None:
        """Stop the sampler and restore full-fidelity-off defaults."""
        with self._lock:
            t = self._thread
            self._thread = None
            self._stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._tracer.sample_n = 1
        self._tracer.disable()
        self._registry.counted_dispatch = True
        self._registry.disable()

    def _main(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:      # pragma: no cover - contained by contract
                pass

    # -- sampling ------------------------------------------------------------
    def tick(self, now: float | None = None) -> None:
        """One sampler pass: registry -> series rings, then probes."""
        t0 = time.perf_counter()
        ts = time.time() if now is None else float(now)
        fams = self._registry.collect()
        with self._lock:
            for name, c in fams["counters"]:
                self._append(f"counter.{name}", ts, c.snapshot())
            for name, g in fams["gauges"]:
                self._append(f"gauge.{name}", ts, g.snapshot())
            for name, h in fams["histograms"]:
                self._append(f"hist.{name}.count", ts, h.count)
                self._append(f"hist.{name}.p50", ts, h.percentile(0.50))
                self._append(f"hist.{name}.p99", ts, h.percentile(0.99))
            probes = list(self._probes)
        for fn in probes:
            try:
                fn()
            except Exception:      # pragma: no cover - contained by contract
                pass
        self.ticks += 1
        self.last_tick_s = time.perf_counter() - t0

    def _append(self, key: str, ts: float, value: float) -> None:
        ring = self._series.get(key)
        if ring is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                return
            ring = self._series[key] = collections.deque(
                maxlen=self.series_maxlen)
        ring.append((round(ts, 3), float(value)))

    # -- probes --------------------------------------------------------------
    def add_probe(self, fn) -> None:
        """Run ``fn()`` once per tick (exceptions contained)."""
        with self._lock:
            self._probes.append(fn)

    def remove_probe(self, fn) -> None:
        with self._lock:
            try:
                self._probes.remove(fn)
            except ValueError:
                pass

    # -- inspection ----------------------------------------------------------
    def series(self, key: str) -> list[tuple[float, float]]:
        """One series' ``(ts, value)`` points, oldest first."""
        with self._lock:
            ring = self._series.get(key)
            return list(ring) if ring is not None else []

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self) -> dict:
        """JSON-able dump of the recorder state + every time-series ring
        (the ``metrics.json`` payload of an incident bundle)."""
        with self._lock:
            series = {k: [[t, v] for t, v in ring]
                      for k, ring in sorted(self._series.items())}
        return {
            "armed": self.armed,
            "interval_s": self.interval_s,
            "span_sample": self.span_sample,
            "ticks": int(self.ticks),
            "dropped_series": int(self.dropped_series),
            "last_tick_s": round(float(self.last_tick_s), 6),
            "series": series,
        }

    def clear(self) -> None:
        """Drop recorded series (dials and armed state untouched)."""
        with self._lock:
            self._series.clear()
            self.dropped_series = 0


# THE process-global recorder (arm it once at service start)
RECORDER = FlightRecorder()
