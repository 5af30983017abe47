"""Automatic incident bundles: debounced, retention-capped post-mortems.

When something the resilience layer classifies as an incident happens —
a breaker opens, the fallback chain exhausts, a merge fails or its
worker dies, the admission queue sheds, a generation is quarantined, a
manifest reads corrupt, a device drops out of the mesh, an SLO burns
through its budget — the installed :class:`IncidentManager` writes one
on-disk bundle capturing everything an operator needs *at that moment*:

    incidents/0007-breaker-open/
        incident.json   kind, reason, context, armed faults + trip counts
        health.json     the service health() dict at trigger time
        metrics.json    registry snapshot + flight-recorder series rings
        spans.jsonl     the recent (sampled) span ring, one event/line
        metrics.prom    Prometheus text, scrape-identical to /metrics

Rules that make this safe to leave on in production:

- **Debounce per kind.** A flapping breaker produces one bundle per
  ``debounce_s`` window, not one per transition; suppressed triggers are
  counted in ``debounced``.
- **Retention cap.** Only the newest ``retention`` bundles are kept;
  older directories are deleted on each write.
- **Never raises.** The module-level :func:`report` hook — the only API
  production code calls — is a no-op when no manager is installed and
  swallows (logs) every bundle-write failure. A full disk must not take
  down serving.

Production code imports nothing but :func:`report`; the serving/
resilience layers stay import-light and the obs package never imports
them (the armed-faults payload is fetched lazily at write time).

The port's own copy of ``repro.obs.incident``: the same kinds, bundle
names and files. ``device.loss`` is fired by the service's router when a
slot's slab fails to load (``distrib``).
"""
from __future__ import annotations

import json
import logging
import pathlib
import re
import shutil
import threading
import time

from .export import prometheus_text
from .metrics import METRICS, MetricsRegistry
from .recorder import RECORDER, FlightRecorder
from .trace import TRACE, Tracer

__all__ = ["DEFAULT_DEBOUNCE_S", "DEFAULT_RETENTION", "IncidentManager",
           "install", "manager", "report", "uninstall"]

log = logging.getLogger("repro_torch.obs.incident")

DEFAULT_DEBOUNCE_S = 30.0
DEFAULT_RETENTION = 20

# the built-in trigger kinds wired through the stack (slo.<name> kinds
# are dynamic, one per breached spec)
INCIDENT_KINDS = (
    "breaker.open",            # resilience.breakers: -> OPEN transition
    "backend.unavailable",     # serving: fallback chain exhausted
    "merge.failure",           # serving: merge/publish raised
    "merge.worker_death",      # serving: background worker died
    "queue.shed",              # serving: admission queue overflow
    "generation.quarantine",   # serving.open(): LKG recovery quarantined
    "manifest.corrupt",        # persist: torn/CRC-mismatched manifest
    "manifest.commit_failed",  # persist: atomic commit failed
    "device.loss",             # distrib: partition load lost a device
)

_BUNDLE_RE = re.compile(r"^(\d+)-")


def _san(kind: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "_-" else "-"
                   for ch in kind)


def _armed_faults() -> dict:
    """The fault registry's armed points + lifetime trip counts. Imported
    lazily so the obs package never depends on resilience at import time
    (resilience imports obs, not the other way around)."""
    try:
        from ..resilience.faults import FAULTS
        return FAULTS.snapshot()
    except Exception:              # pragma: no cover - import-order safety
        return {}


class IncidentManager:
    """Debounced, retention-capped bundle writer rooted at one directory.

    ``health_source`` (also settable later via :meth:`bind_health`) is a
    zero-arg callable producing the health dict for triggers fired from
    code that has no service handle (breakers, manifest IO). A trigger
    may also pass its own ``health`` — a dict or callable — which wins.
    """

    def __init__(self, root, *, debounce_s: float = DEFAULT_DEBOUNCE_S,
                 retention: int = DEFAULT_RETENTION,
                 registry: MetricsRegistry = METRICS,
                 tracer: Tracer = TRACE,
                 recorder: FlightRecorder = RECORDER,
                 health_source=None,
                 clock=time.monotonic):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.debounce_s = float(debounce_s)
        self.retention = int(retention)
        self._registry = registry
        self._tracer = tracer
        self._recorder = recorder
        self._health_source = health_source
        self._clock = clock
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self.written = 0
        self.debounced: dict[str, int] = {}
        # continue the sequence across restarts so retention-by-name holds
        self._seq = max((int(m.group(1)) for p in self.root.iterdir()
                         if (m := _BUNDLE_RE.match(p.name))), default=0)

    def bind_health(self, fn) -> None:
        """(Re)bind the default health source — e.g. after a service
        reopen replaces the instance whose ``health`` was captured."""
        self._health_source = fn

    # -- trigger -------------------------------------------------------------
    def trigger(self, kind: str, reason: str = "", *, health=None,
                context: dict | None = None) -> pathlib.Path | None:
        """Write a bundle for ``kind`` unless one was written within the
        debounce window; returns the bundle dir (None when debounced)."""
        with self._lock:
            now = self._clock()
            last = self._last.get(kind)
            if last is not None and now - last < self.debounce_s:
                self.debounced[kind] = self.debounced.get(kind, 0) + 1
                return None
            self._last[kind] = now
            self._seq += 1
            bundle = self.root / f"{self._seq:04d}-{_san(kind)}"
            self._write(bundle, kind, reason, health, context)
            self._sweep()
            self.written += 1
        if self._tracer.enabled:
            self._tracer.event("incident.bundle", kind=kind,
                               path=str(bundle))
        return bundle

    # -- bundle assembly -----------------------------------------------------
    def _write(self, bundle: pathlib.Path, kind: str, reason: str,
               health, context: dict | None) -> None:
        src = health if health is not None else self._health_source
        if callable(src):
            try:
                src = src()
            except Exception as e:  # health itself may be mid-failure
                src = {"error": repr(e)}
        manifest = {
            "kind": kind,
            "reason": str(reason),
            "seq": self._seq,
            "wall_time": time.time(),
            "context": context or {},
            "armed_faults": _armed_faults(),
        }
        if isinstance(src, dict):
            # headline identity of what was serving (full dict in
            # health.json; these keys make `cat incident.json` enough)
            for k in ("generation", "epoch", "degraded", "closed"):
                if k in src:
                    manifest[k] = src[k]
        bundle.mkdir(parents=True, exist_ok=True)
        dump = dict(sort_keys=True, indent=1, default=repr)
        (bundle / "incident.json").write_text(
            json.dumps(manifest, **dump) + "\n")
        (bundle / "health.json").write_text(
            json.dumps(src, **dump) + "\n")
        (bundle / "metrics.json").write_text(json.dumps(
            {"registry": self._registry.snapshot(),
             "recorder": self._recorder.snapshot()}, **dump) + "\n")
        (bundle / "spans.jsonl").write_text(self._tracer.to_jsonl() + "\n")
        (bundle / "metrics.prom").write_text(
            prometheus_text(self._registry))

    def _sweep(self) -> None:
        dirs = sorted(p for p in self.root.iterdir()
                      if p.is_dir() and _BUNDLE_RE.match(p.name))
        for p in dirs[:max(0, len(dirs) - self.retention)]:
            shutil.rmtree(p, ignore_errors=True)

    def bundles(self) -> list[pathlib.Path]:
        """Bundle directories on disk, oldest first."""
        return sorted(p for p in self.root.iterdir()
                      if p.is_dir() and _BUNDLE_RE.match(p.name))


# -- module-level installation (what production hook sites call) ------------
_manager: IncidentManager | None = None
_install_lock = threading.Lock()


def install(root, **kw) -> IncidentManager:
    """Install the process-global incident manager rooted at ``root``."""
    global _manager
    with _install_lock:
        _manager = IncidentManager(root, **kw)
        return _manager


def uninstall() -> None:
    global _manager
    with _install_lock:
        _manager = None


def manager() -> IncidentManager | None:
    return _manager


def report(kind: str, reason: str = "", *, health=None, **context) -> None:
    """Fire-and-forget incident hook for production code paths.

    No-op when no manager is installed; never raises — an incident
    bundle is evidence, not a second failure mode.
    """
    m = _manager
    if m is None:
        return
    try:
        m.trigger(kind, reason, health=health, context=context or None)
    except Exception:              # pragma: no cover - full disk etc.
        log.warning("incident bundle for %r failed", kind, exc_info=True)
