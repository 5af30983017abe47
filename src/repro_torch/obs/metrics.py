"""Process-global metrics registry: counters, gauges, histograms, vectors.

The port's own copy of ``repro.obs.metrics`` (numpy and the standard
library only): the same instruments and switches, with state separate from
the reference's registry.

Design constraints, in order:

1. **Disabled is free.** ``METRICS.enabled`` is a plain bool attribute;
   every hook site in the serving stack guards on it (one attribute read),
   so the unobserved hot path never touches an instrument.
2. **Observing is lock-free for a single writer.** Instrument mutation
   (``inc``/``set``/``observe``/``add``) takes no lock: plain int/float
   adds and fixed-size numpy scatter under the GIL. The serving layer's
   writers are effectively single per instrument (dispatch threads hold
   the service lock at the queue sites; lock-free readers only touch
   call-scoped histograms); concurrent writers at worst lose a count —
   telemetry is best-effort by contract, results never flow through it.
   Only instrument *creation* synchronises (one dict lock).
3. **Percentiles from raw samples.** Each histogram keeps a fixed
   log-spaced bucket plane (Prometheus-style cumulative export) plus a
   ring buffer of the last ``RING_SIZE`` raw observations; p50/p90/p99
   are computed from the ring at snapshot time, so tails are exact over
   the recent window instead of bucket-interpolated.
"""
from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["METRICS", "Counter", "CounterVec", "Gauge", "Histogram",
           "MetricsRegistry", "RING_SIZE"]

RING_SIZE = 4096                       # power of two: masked ring index
_RING_MASK = RING_SIZE - 1

# default bucket upper edges: 4 per decade over 1 .. 1e10 — wide enough
# for ns, us, and byte-count observations without per-instrument tuning
_DEFAULT_EDGES = tuple(float(f"{10 ** (e / 4):.4g}") for e in range(41))


class Counter:
    """Monotonic counter. Single-writer lock-free ``inc``."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> int:
        return int(self.value)


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return float(self.value)


class CounterVec:
    """Fixed-length vector of counters (e.g. one slot per shard).

    ``add`` folds a whole host array in one vectorised add — the shape the
    device counter planes arrive in. The length is fixed at creation; the
    registry replaces (resets) a vector whose requested length changed,
    which is exactly the snapshot-swap semantics the per-shard planes
    need (a merge may change the shard count).
    """

    __slots__ = ("name", "values")

    def __init__(self, name: str, size: int):
        self.name = name
        self.values = np.zeros(int(size), np.int64)

    def add(self, arr) -> None:
        a = np.asarray(arr)
        if a.shape != self.values.shape:
            raise ValueError(f"CounterVec {self.name!r}: add shape "
                             f"{a.shape} != {self.values.shape}")
        self.values += a

    def add_at(self, i: int, n: int = 1) -> None:
        self.values[i] += n

    def snapshot(self) -> list[int]:
        return [int(x) for x in self.values]


class Histogram:
    """Fixed-bucket histogram + raw-sample ring buffer.

    ``observe`` is a handful of scalar ops and one ``searchsorted`` over
    ~40 edges — cheap enough for per-call (not per-key) serving sites.
    ``counts[b]`` counts observations ``<= edges[b]`` (the final slot is
    the +Inf overflow), matching Prometheus ``le`` semantics at export.
    """

    __slots__ = ("name", "edges", "counts", "count", "sum", "max",
                 "_ring", "_n")

    def __init__(self, name: str, edges=None):
        self.name = name
        self.edges = np.asarray(edges if edges is not None
                                else _DEFAULT_EDGES, np.float64)
        if self.edges.size < 1 or np.any(np.diff(self.edges) <= 0):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = np.zeros(self.edges.size + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._ring = np.zeros(RING_SIZE, np.float64)
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v
        self._ring[self._n & _RING_MASK] = v
        self._n += 1
        self.counts[int(np.searchsorted(self.edges, v, side="left"))] += 1

    def samples(self) -> np.ndarray:
        """The raw recent-sample window (unordered; up to RING_SIZE)."""
        return self._ring[:min(self._n, RING_SIZE)].copy()

    def percentile(self, p: float) -> float:
        """Exact percentile over the recent sample window (0 when empty)."""
        s = self.samples()
        if s.size == 0:
            return 0.0
        s.sort()
        return float(s[min(s.size - 1, int(math.ceil(p * s.size)) - 1)]) \
            if p > 0 else float(s[0])

    def snapshot(self) -> dict:
        return {
            "count": int(self.count),
            "sum": round(float(self.sum), 3),
            "max": round(float(self.max), 3),
            "p50": round(self.percentile(0.50), 3),
            "p90": round(self.percentile(0.90), 3),
            "p99": round(self.percentile(0.99), 3),
        }

    def bucket_counts(self) -> list[tuple[float, int]]:
        """Cumulative Prometheus-style ``(le, count)`` pairs (ends with
        ``(inf, count)``)."""
        cum = np.cumsum(self.counts)
        out = [(float(le), int(c)) for le, c in zip(self.edges, cum[:-1])]
        out.append((float("inf"), int(cum[-1])))
        return out


class MetricsRegistry:
    """Named instrument table with a global enable switch.

    Accessors are get-or-create: ``METRICS.counter("wal.append_bytes")``
    registers on first use under the creation lock and returns the shared
    instance afterwards via one dict hit. ``enabled`` gates the *callers*
    (hook sites check it before touching any instrument); the registry
    itself never refuses writes, so tests and exporters can drive
    instruments directly.
    """

    def __init__(self):
        self.enabled = False
        # full-fidelity dial: when set (the default), enabling the registry
        # also routes stacked serving through the counted dispatch (K1's
        # counter plane -> exact live hotness / probe histograms), which
        # costs real device work per block. Clearing it keeps the registry
        # on while serving through the uncounted kernel: the flight
        # recorder clears it while armed (obs.recorder).
        self.counted_dispatch = True
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._vectors: dict[str, CounterVec] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, edges=None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = Histogram(name, edges)
                    self._histograms[name] = h
        return h

    def vector(self, name: str, size: int) -> CounterVec:
        """Get-or-create a fixed-length counter vector; a length change
        replaces (resets) it — per-shard planes are epoch-scoped and a
        merge may change the shard count."""
        v = self._vectors.get(name)
        if v is None or v.values.size != int(size):
            with self._lock:
                v = self._vectors.get(name)
                if v is None or v.values.size != int(size):
                    v = CounterVec(name, size)
                    self._vectors[name] = v
        return v

    def reset(self) -> None:
        """Drop every instrument (the enable switch is untouched)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._vectors.clear()

    def collect(self) -> dict[str, list]:
        """Locked, point-in-time item lists of every instrument family —
        THE public iteration API for exporters.

        Instruments register concurrently (the background merge worker's
        first ``merge.cycles`` inc, a late backend's dispatch counter), so
        walking the family dicts live can raise ``RuntimeError: dictionary
        changed size during iteration`` mid-scrape. The snapshot here is
        taken under the creation lock; the returned lists are the caller's
        to iterate at leisure (instrument *values* stay live — reading
        them is the same best-effort contract as every other read)."""
        with self._lock:
            return {
                "counters": sorted(self._counters.items()),
                "gauges": sorted(self._gauges.items()),
                "histograms": sorted(self._histograms.items()),
                "vectors": sorted(self._vectors.items()),
            }

    def snapshot(self) -> dict:
        """One JSON-serialisable view of every instrument."""
        fams = self.collect()
        return {
            "counters": {n: c.snapshot() for n, c in fams["counters"]},
            "gauges": {n: g.snapshot() for n, g in fams["gauges"]},
            "histograms": {n: h.snapshot() for n, h in fams["histograms"]},
            "vectors": {n: v.snapshot() for n, v in fams["vectors"]},
        }


# THE process-global registry every hook site writes to
METRICS = MetricsRegistry()
