"""Observability of the port: the process-global metrics registry
(``metrics.METRICS``). Tracing, exporters and incident reports are a later
slice (``ROADMAP.md`` queue 1, item 8)."""
from .metrics import METRICS, Counter, CounterVec, Gauge, Histogram, \
    MetricsRegistry

__all__ = ["METRICS", "Counter", "CounterVec", "Gauge", "Histogram",
           "MetricsRegistry"]
