"""Span-based pipeline tracing with a bounded JSON-lines event log.

Usage at a hook site::

    with TRACE.span("serve.dispatch", n=q.size):
        ...                               # timed body

Spans nest per thread (``depth`` in the emitted event is the nesting
level at entry), and two post-hoc forms cover work that was timed
elsewhere: ``record(name, dur_s, **attrs)`` emits a span that *ended
now* with a known duration (queue waits, ``BuildStats`` phases), and
``event(name, **attrs)`` emits a zero-duration marker (breaker state
transitions).

Disabled (default), ``span`` returns one shared null context manager and
``record``/``event`` return immediately — a hook site costs an attribute
read and a predictable branch, never an allocation. Enabled, events append
to a bounded deque (thread-safe by CPython contract), so a long soak
keeps the newest ``maxlen`` events instead of growing without bound.

``sample_n`` is the always-on production dial (the flight recorder sets
it when armed): with ``sample_n = N > 1``, ``span`` and ``record`` keep
every Nth call per thread and the rest cost one thread-local counter
bump — no ``_Span`` allocation, no deque append. ``event`` is never
sampled: events mark rare state transitions (breaker opens, SLO
breaches) that an incident bundle must not miss.

The span taxonomy threaded through the repo (see README "Observability"):

    serve.lookup / serve.submit / serve.queue_wait / serve.staging /
    serve.dispatch / serve.sync / serve.drain
    build.shard / build.spline / build.tune / build.layer
    merge.capture / merge.build / merge.publish
    wal.append / wal.fsync / persist.open / breaker.transition

The port's own copy of ``repro.obs.trace`` (numpy-free, standard library
only), with state separate from the reference's tracer. One difference:
an attribute that is a ``torch.Tensor`` is exported as its shape, dtype and
device, never its values. Reading a value of a CUDA tensor (``.item()``,
or a ``repr`` that prints it) waits for the card, and a span must not
stall the serving stream between K1's overlapped launches; every hook site
passes host numbers anyway.
"""
from __future__ import annotations

import collections
import json
import sys
import threading
import time

__all__ = ["TRACE", "Tracer"]

DEFAULT_MAXLEN = 65536


def _jsonable(v):
    """Coerce an attr value to something json.dumps accepts (numpy scalars
    arrive from counter folds). A torch tensor is described, not read: no
    ``.item()``, so no device sync (torch is looked up only if imported)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        return (f"tensor(shape={list(v.shape)}, dtype={v.dtype}, "
                f"device={v.device})")
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:           # pragma: no cover - exotic array attr
            pass
    return repr(v)


class _NullSpan:
    """The shared disabled-path context manager (no state, no allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "attrs", "_t0", "_depth")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self._tr = tr
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = self._tr._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        stack = self._tr._stack()
        # Truncate back to this span's frame rather than popping only an
        # exact top-of-stack match: a mismatched or exception-crossed exit
        # (inner span leaked by a generator, exits out of order) must not
        # leave stale frames inflating every later span's depth. Identity
        # scan from the top — the common case is still one comparison.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i:]
                break
        self._tr._emit(self.name, self._t0, dur, self._depth, self.attrs)
        return False                # exceptions propagate; the span records


class Tracer:
    """Process-global span recorder (see the module docstring)."""

    def __init__(self, maxlen: int = DEFAULT_MAXLEN):
        self.enabled = False
        self.sample_n = 1          # keep 1-in-N spans/records per thread
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._tls = threading.local()
        # perf_counter -> wall-clock offset, so exported timestamps are
        # epoch seconds while in-process timing stays monotonic
        self._wall_offset = time.time() - time.perf_counter()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _sampled(self) -> bool:
        """Per-thread 1-in-``sample_n`` admission (True when unsampled)."""
        n = self.sample_n
        if n <= 1:
            return True
        c = getattr(self._tls, "ctr", 0) + 1
        self._tls.ctr = c
        return c % n == 0

    def span(self, name: str, **attrs):
        """Timed context manager; the shared null context when disabled
        (and for the skipped fraction under ``sample_n`` sampling)."""
        if not self.enabled or not self._sampled():
            return _NULL
        return _Span(self, name, attrs)

    def record(self, name: str, dur_s: float, **attrs) -> None:
        """Post-hoc span that ended now with a known duration."""
        if not self.enabled or not self._sampled():
            return
        t1 = time.perf_counter()
        self._emit(name, t1 - dur_s, dur_s, len(self._stack()), attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker (state transitions, one-shot facts)."""
        if not self.enabled:
            return
        self._emit(name, time.perf_counter(), 0.0, len(self._stack()), attrs)

    def _emit(self, name: str, t0: float, dur_s: float, depth: int,
              attrs: dict) -> None:
        ev = {
            "name": name,
            "ts": round(self._wall_offset + t0, 6),
            "dur_us": round(dur_s * 1e6, 3),
            "depth": depth,
            "thread": threading.current_thread().name,
        }
        if attrs:
            ev["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        self._events.append(ev)

    # -- inspection / export -------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of the recorded events, oldest first."""
        return list(self._events)

    def span_names(self) -> set[str]:
        return {ev["name"] for ev in self._events}

    def clear(self) -> None:
        self._events.clear()

    def to_jsonl(self) -> str:
        """The event log as JSON lines (one event per line)."""
        return "\n".join(json.dumps(ev, sort_keys=True)
                         for ev in self._events)


# THE process-global tracer every hook site records into
TRACE = Tracer()
