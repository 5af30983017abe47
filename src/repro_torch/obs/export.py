"""Exporters: Prometheus text format + JSONL event/metrics dump.

``prometheus_text`` renders the registry in the Prometheus exposition
format (text/plain version 0.0.4): counters as ``<name>_total``, gauges
plainly, histograms as cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``, exact recent-window quantiles as a *separate*
``<name>_recent`` gauge family (``{quantile="0.5"}`` etc. — a sample
under the histogram family name itself is invalid exposition and real
scrapers reject the whole page), and counter vectors as one labelled
series per slot (``{shard="i"}``). Metric names are sanitised (dots
become underscores) and prefixed, so ``serve.lookup_us`` scrapes as
``plex_serve_lookup_us``. Iteration goes through the registry's locked
``collect()`` snapshot, so a scrape concurrent with instrument
registration (the background merge worker's first cycle) can't hit a
dict-mutated-during-iteration error.

``write_jsonl`` appends one ``{"type": "metrics", ...}`` summary line
after the trace's ``{"type": "span", ...}`` lines, so a single file
carries the whole observation (the artifact the observability drill,
``python -m repro_torch.launch.observe``, writes).

The port's own copy of ``repro.obs.export``, over the port's registry and
tracer; the same operations on both registries give byte-identical text.
"""
from __future__ import annotations

import json
import pathlib

from .metrics import METRICS, MetricsRegistry
from .trace import TRACE, Tracer

__all__ = ["prometheus_text", "write_jsonl", "write_prometheus"]

DEFAULT_PREFIX = "plex"


def _san(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    return "".join(out)


def prometheus_text(registry: MetricsRegistry = METRICS, *,
                    prefix: str = DEFAULT_PREFIX) -> str:
    """The registry in Prometheus exposition text format."""
    lines: list[str] = []
    fams = registry.collect()
    for name, c in fams["counters"]:
        m = f"{prefix}_{_san(name)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {c.snapshot()}")
    for name, g in fams["gauges"]:
        m = f"{prefix}_{_san(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {g.snapshot()}")
    for name, h in fams["histograms"]:
        m = f"{prefix}_{_san(name)}"
        lines.append(f"# TYPE {m} histogram")
        for le, count in h.bucket_counts():
            le_s = "+Inf" if le == float("inf") else f"{le:g}"
            lines.append(f'{m}_bucket{{le="{le_s}"}} {count}')
        lines.append(f"{m}_sum {h.sum:g}")
        lines.append(f"{m}_count {h.count}")
        # exact recent-window quantiles: a distinct gauge family — only
        # _bucket/_sum/_count samples may live under a histogram TYPE
        qm = f"{m}_recent"
        lines.append(f"# TYPE {qm} gauge")
        for q in (0.5, 0.9, 0.99):
            lines.append(f'{qm}{{quantile="{q:g}"}} {h.percentile(q):g}')
    for name, v in fams["vectors"]:
        m = f"{prefix}_{_san(name)}_total"
        lines.append(f"# TYPE {m} counter")
        for i, val in enumerate(v.snapshot()):
            lines.append(f'{m}{{shard="{i}"}} {val}')
    return "\n".join(lines) + "\n"


def write_prometheus(path, registry: MetricsRegistry = METRICS, *,
                     prefix: str = DEFAULT_PREFIX) -> pathlib.Path:
    path = pathlib.Path(path)
    path.write_text(prometheus_text(registry, prefix=prefix))
    return path


def write_jsonl(path, tracer: Tracer = TRACE,
                registry: MetricsRegistry | None = METRICS) -> pathlib.Path:
    """Write the trace event log (one JSON object per line, ``type:
    "span"``) followed by one ``type: "metrics"`` registry-snapshot line
    (omitted when ``registry`` is None)."""
    path = pathlib.Path(path)
    with open(path, "w") as fh:
        for ev in tracer.events():
            fh.write(json.dumps({"type": "span", **ev}, sort_keys=True))
            fh.write("\n")
        if registry is not None:
            fh.write(json.dumps({"type": "metrics",
                                 **registry.snapshot()}, sort_keys=True))
            fh.write("\n")
    return path
