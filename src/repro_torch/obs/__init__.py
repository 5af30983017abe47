"""End-to-end observability of the port: process-global metrics + span
tracing, and the production layer on top (the port's own copy of
``repro.obs``; numpy and the standard library only, never torch).

Two process-global singletons, both **disabled by default**:

* ``METRICS`` (``obs.metrics.MetricsRegistry``) — counters, gauges,
  fixed-bucket histograms with a ring buffer of raw samples
  (p50/p90/p99/max), and fixed-length counter vectors (per-shard planes).
  While it is enabled with ``counted_dispatch`` set, the fused service
  serves through K1's counted variant.
* ``TRACE`` (``obs.trace.Tracer``) — span-based tracing with thread-local
  nesting and a bounded event log that exports as JSON lines. Spans time
  the host clock: ``serve.dispatch`` is the enqueue of K1's launches,
  ``serve.sync`` the wait and the copy back; no span syncs the card.

A disabled hook site costs one attribute read (``if METRICS.enabled:`` /
``TRACE.span(...)`` returning a shared null context), so the hooks live
permanently inside the serving pipeline.

On top of the singletons:

* ``RECORDER`` (``obs.recorder.FlightRecorder``) — the always-on mode:
  1-in-N span sampling plus a background sampler thread snapshotting
  registry series into bounded time rings (K1's uncounted variant serves
  while it is armed).
* ``obs.slo`` — declarative SLO specs evaluated with multi-window burn
  rates, surfaced as ``health()["slo"]`` and ``slo.breach`` events.
* ``obs.incident`` — debounced, retention-capped on-disk incident
  bundles written on breaker opens, chain exhaustion, merge failures,
  queue sheds, quarantines, corrupt manifests and SLO breaches.
* ``obs.export`` — Prometheus text and the JSONL event log.
"""
from __future__ import annotations

from .incident import IncidentManager
from .metrics import METRICS, Counter, CounterVec, Gauge, Histogram, \
    MetricsRegistry
from .recorder import RECORDER, FlightRecorder
from .slo import SLOSpec, SLOWatchdog, default_slos, watch_service
from .trace import TRACE, Tracer

__all__ = ["METRICS", "RECORDER", "TRACE", "Counter", "CounterVec",
           "FlightRecorder", "Gauge", "Histogram", "IncidentManager",
           "MetricsRegistry", "SLOSpec", "SLOWatchdog", "Tracer",
           "default_slos", "disable_observability", "enable_observability",
           "observability_enabled", "watch_service"]


def enable_observability() -> None:
    """Arm both singletons (metrics + tracing)."""
    METRICS.enable()
    TRACE.enable()


def disable_observability() -> None:
    """Disarm both singletons; accumulated data is kept until ``reset``/
    ``clear`` so a report can still be exported after a measured run."""
    METRICS.disable()
    TRACE.disable()


def observability_enabled() -> bool:
    return METRICS.enabled or TRACE.enabled
