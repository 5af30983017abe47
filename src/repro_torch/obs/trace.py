"""Span-based pipeline tracing with a bounded JSON-lines event log.

Usage at a hook site::

    with TRACE.span("serve.dispatch", n=q.size):
        ...                               # timed body

Spans nest per thread, and two post-hoc forms cover work that was timed
elsewhere: ``record(name, dur_s, **attrs)`` emits a span that *ended
now* with a known duration (queue waits, ``BuildStats`` phases), and
``event(name, **attrs)`` emits a zero-duration marker (breaker state
transitions). A span's attributes may be completed inside its body with
``span.set(**attrs)`` (a no-op on a span that is not recorded).

Every emitted event carries an ``id`` (unique in the process), its
``parent`` (the id of the span enclosing it on this thread, ``None`` at
a root), ``depth`` (the nesting level at entry), ``t0`` (its start on the
``time.perf_counter`` clock, in seconds: the clock a profiler's markers
map onto a device trace) and ``ts`` (the same start in epoch seconds).
A span's self time is its ``dur_us`` less its children's.

Disabled (default), ``span`` returns one shared null context manager and
``record``/``event`` return immediately — a hook site costs an attribute
read and a predictable branch, never an allocation. Enabled, an event is
one tuple appended to a bounded deque (thread-safe by CPython contract),
shaped into its JSON-ready dict only when read (``events()``), so a long
soak keeps the newest ``maxlen`` events instead of growing without bound;
``dropped`` counts the events the ring pushed out since ``clear()``, so a
reader can refuse a window that lost some.

``sample_n`` is the always-on production dial (the flight recorder sets
it when armed): with ``sample_n = N > 1`` the decision is taken at a root
(a span or record with no span open on its thread), which keeps every Nth
root per thread; everything inside a root follows its decision, so a
request's spans are kept or dropped together. A dropped root costs one
thread-local counter bump and a shared marker on the thread's stack — no
``_Span`` allocation, no deque append. ``event`` is never sampled: events
mark rare state transitions (breaker opens, SLO breaches) that an
incident bundle must not miss.

The span taxonomy threaded through the repo (see README "Observability"):

    serve.lookup / serve.staging / serve.dispatch / serve.sync
    serve.submit / serve.lock / serve.take / serve.queue_wait /
    serve.timer / serve.drain / serve.drain.wait / serve.copy_back /
    serve.cache_count / serve.fill / serve.deadline_flush /
    serve.new_state
    build.shard / build.spline / build.tune / build.layer
    merge.capture / merge.build / merge.publish
    wal.append / wal.fsync / persist.open / breaker.transition

A served request's spans carry its ticket's id (``req``), and a queue
block's spans the ids of every ticket with lanes in it (``reqs``), so a
block answered on the deadline timer's thread is still tied to its
requests (``serving.plex_service`` has the tree).

The port's own copy of ``repro.obs.trace`` (numpy-free, standard library
only), with state separate from the reference's tracer. Differences: the
ids, ``t0``, ``dropped``, ``set`` and sampling at the root are the port's
alone, and an attribute that is a ``torch.Tensor`` is exported as its
shape, dtype and device, never its values (attributes are kept as given
and coerced when read, so such a tensor stays alive while its event is
in the ring). Reading a value of a CUDA
tensor (``.item()``, or a ``repr`` that prints it) waits for the card, and
a span must not stall the serving stream between K1's overlapped launches;
every hook site passes host numbers anyway.
"""
from __future__ import annotations

import collections
import itertools
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
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]      # a block's request ids
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

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


def _unwind(stack: list, frame) -> None:
    """Truncate the thread's stack back to ``frame`` rather than popping
    only an exact top-of-stack match: a mismatched or exception-crossed
    exit (an inner span leaked by a generator, exits out of order) must
    not leave stale frames inflating every later span's depth. Identity
    scan from the top — the common case is still one comparison."""
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is frame:
            del stack[i:]
            break


class _Stack(list):
    """A thread's open spans, innermost last, and the thread's name (read
    once, when the thread first traces)."""

    __slots__ = ("name",)


class _Skipped:
    """A root that sampling left out, and everything inside it: one shared
    marker per tracer on the thread's stack, so the root's children see
    the decision and are left out with it."""

    __slots__ = ("_tr",)
    id = None                       # never the parent of an emitted event

    def __init__(self, tr: "Tracer"):
        self._tr = tr

    def __enter__(self):
        self._tr._stack().append(self)
        return self

    def __exit__(self, *exc):
        _unwind(self._tr._stack(), self)
        return False

    def set(self, **attrs) -> None:
        pass


class _Span:
    __slots__ = ("_tr", "name", "attrs", "id", "parent", "_t0", "_depth",
                 "_stack")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self._tr = tr
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span's body."""
        self.attrs.update(attrs)

    def __enter__(self):
        tr = self._tr
        stack = self._stack = tr._stack()
        self._depth = len(stack)
        self.parent = stack[-1].id if stack else None
        self.id = next(tr._ids)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        else:
            _unwind(stack, self)
        tr = self._tr
        events = tr._events
        if len(events) == events.maxlen:
            tr._count_drop()
        events.append((self.name, self.id, self.parent, self._t0,
                       t1 - self._t0, self._depth, stack.name, self.attrs))
        return False                # exceptions propagate; the span records


class Tracer:
    """Process-global span recorder (see the module docstring)."""

    def __init__(self, maxlen: int = DEFAULT_MAXLEN):
        self.enabled = False
        self.sample_n = 1          # keep 1-in-N roots per thread
        self.dropped = 0           # events the full ring pushed out
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._skipped = _Skipped(self)
        self._drop_lock = threading.Lock()
        # perf_counter -> wall-clock offset, so exported timestamps are
        # epoch seconds while in-process timing stays monotonic
        self._wall_offset = time.time() - time.perf_counter()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _stack(self) -> _Stack:
        try:
            return self._tls.stack
        except AttributeError:
            st = self._tls.stack = _Stack()
            st.name = threading.current_thread().name
            return st

    def _sampled(self) -> bool:
        """Admission under ``sample_n``: a root takes the per-thread
        1-in-``sample_n`` decision, anything inside a root takes the
        root's (True when unsampled)."""
        n = self.sample_n
        if n <= 1:
            return True
        stack = self._stack()
        if stack:
            return stack[0] is not self._skipped
        c = getattr(self._tls, "ctr", 0) + 1
        self._tls.ctr = c
        return c % n == 0

    def span(self, name: str, **attrs):
        """Timed context manager; the shared null context when disabled,
        and a shared skip marker for a root (and its children) that
        sampling leaves out."""
        if not self.enabled:
            return _NULL
        if self.sample_n > 1 and not self._sampled():
            return self._skipped
        return _Span(self, name, attrs)

    def record(self, name: str, dur_s: float, **attrs) -> None:
        """Post-hoc span that ended now with a known duration."""
        if not self.enabled or not self._sampled():
            return
        t1 = time.perf_counter()
        self._emit_here(name, t1 - dur_s, dur_s, attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker (state transitions, one-shot facts)."""
        if not self.enabled:
            return
        self._emit_here(name, time.perf_counter(), 0.0, attrs)

    def _emit_here(self, name: str, t0: float, dur_s: float,
                   attrs: dict) -> None:
        """Emit a record or event as a child of this thread's open span."""
        stack = self._stack()
        self._emit((name, next(self._ids), stack[-1].id if stack else None,
                    t0, dur_s, len(stack), stack.name, attrs))

    def _emit(self, rec: tuple) -> None:
        """Append one raw record (name, id, parent, t0, dur_s, depth,
        thread, attrs); ``events()`` shapes it, so the hot path only
        appends."""
        events = self._events
        if len(events) == events.maxlen:
            self._count_drop()
        events.append(rec)

    def _count_drop(self) -> None:
        """One event is about to push the oldest out of the full ring."""
        with self._drop_lock:
            self.dropped += 1

    def _shape(self, rec: tuple) -> dict:
        name, eid, parent, t0, dur_s, depth, thread, attrs = rec
        ev = {
            "name": name,
            "id": eid,
            "parent": parent,
            "t0": t0,
            "ts": round(self._wall_offset + t0, 6),
            "dur_us": round(dur_s * 1e6, 3),
            "depth": depth,
            "thread": thread,
        }
        if attrs:
            ev["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        return ev

    # -- inspection / export -------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of the recorded events, oldest first, each a JSON-ready
        dict (attributes coerced here, off the hot path)."""
        return [self._shape(rec) for rec in list(self._events)]

    def span_names(self) -> set[str]:
        return {rec[0] for rec in list(self._events)}

    def clear(self) -> None:
        """Empty the ring and zero ``dropped`` (ids keep counting)."""
        self._events.clear()
        self.dropped = 0

    def to_jsonl(self) -> str:
        """The event log as JSON lines (one event per line)."""
        return "\n".join(json.dumps(ev, sort_keys=True)
                         for ev in self.events())


# THE process-global tracer every hook site records into
TRACE = Tracer()
