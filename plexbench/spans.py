"""The program's own spans over the profiled span of a ``--trace 1`` run.

    python3 plexbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, with ``repro_torch.obs.TRACE``
armed from the profiler's start to its stop (cleared first; ``METRICS``
stays off, so K1 serves its uncounted, cached variant as untraced). The
program's spans go to the device trace's reduction beside the harness's
``client.*`` ones, through the same two markers, so an idle gap is named by
the innermost span of the program that was open. The result line gains
``program``: the readings below, the tracer's ``dropped`` count, each
span's summed time and the cost of one span on this host.

A request reading is in milliseconds a request: the summed durations of its
spans that start (``t0``, ``time.perf_counter``) and end in the profiled
span ``[h0, h1]``, on whatever thread they ran, over the distinct requests
(``req``) of the ``serve.submit`` spans there. A span still open when the
tracer is disarmed is left out: it ends after the profiler's stop, which
it holds. A reading is ``None`` when the tracer dropped an event or
recorded none.

The children's cover of a parent (``serve.submit``, ``serve.drain``) is
read twice: as it is, and with the garbage collector's passes that fell
inside a parent but outside its children set apart (``_gc_apart``). A
collection runs in whatever code allocated last, and a full one takes a
tenth of a second or more here, so one pass can move the first reading by
several points. The passes are logged over the span (``gc.callbacks``).
"""
from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# reading: the spans it sums (``serve.dispatch`` of the queue path only)
REQUEST_SPANS = {
    "staging_ms": ("serve.take", "serve.staging"),
    "dispatch_ms": ("serve.dispatch",),
    "timer_ms": ("serve.timer",),
    "lock_wait_ms": ("serve.lock",),
    "drain_wait_ms": ("serve.drain.wait",),
    "copy_back_ms": ("serve.copy_back", "serve.cache_count", "serve.fill"),
}
PARENTS = ("serve.submit", "serve.drain", "serve.deadline_flush")


def _end(e) -> float:
    return e["t0"] + e["dur_us"] / 1e6


def in_span(events: list, h0: float, h1: float) -> list:
    """The events that started and ended in ``[h0, h1]``."""
    return [e for e in events if h0 <= e["t0"] and _end(e) <= h1]


def _counted(e, names) -> bool:
    return e["name"] in names and (
        e["name"] != "serve.dispatch"
        or e.get("attrs", {}).get("path") == "queue")


def requests(events: list) -> set:
    """The requests of ``events``: the ids their ``serve.submit`` spans
    carry."""
    return {e["attrs"]["req"] for e in events
            if e["name"] == "serve.submit"}


def request_ms(events: list, h0: float, h1: float, names,
               dropped: int) -> float | None:
    """Milliseconds a request in the spans ``names`` (module docstring)."""
    if dropped or not events:
        return None
    inside = in_span(events, h0, h1)
    reqs = requests(inside)
    if not reqs:
        return None
    return sum(e["dur_us"] for e in inside if _counted(e, names)) \
        / 1e3 / len(reqs)


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def child_share(events: list, h0: float, h1: float, parent: str,
                pauses=()) -> float | None:
    """The share of the summed time of the ``parent`` spans in the span
    that their direct children cover; ``pauses`` ((start, end) on the
    ``perf_counter`` clock) are taken out of a parent's time where they
    fall inside it and outside its children."""
    ps = {e["id"]: e for e in in_span(events, h0, h1)
          if e["name"] == parent}
    kids: dict[int, list] = {p: [] for p in ps}
    for e in events:
        if e["parent"] in kids:
            kids[e["parent"]].append(e)
    total = sum(e["dur_us"] for e in ps.values()) / 1e6
    covered = sum(e["dur_us"] for ks in kids.values() for e in ks) / 1e6
    pauses = sorted(pauses)
    starts = [a for a, _ in pauses]
    for pid, p in ps.items():
        a, b = p["t0"], _end(p)
        for s, t in pauses[max(bisect.bisect_right(starts, a) - 1, 0):
                           bisect.bisect_right(starts, b)]:
            if _overlap(a, b, s, t) > 0:
                total -= _overlap(a, b, s, t) - sum(
                    _overlap(c["t0"], _end(c), s, t) for c in kids[pid])
    if total <= 0:
        return None
    return covered / total


def by_name(events: list, h0: float, h1: float) -> dict:
    """Seconds summed by span name over the span."""
    out: dict[str, float] = {}
    for e in in_span(events, h0, h1):
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur_us"] / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_spans(events: list, h0: float, h1: float) -> list:
    """(name, start, end) on the ``perf_counter`` clock of every span that
    overlaps ``[h0, h1]``, as ``devtrace.reduce_events`` takes them."""
    out = []
    for e in events:
        a = e["t0"]
        b = a + e["dur_us"] / 1e6
        if b > a and b >= h0 and a <= h1:
            out.append((e["name"], a, b))
    return out


def readings(events: list, h0: float, h1: float, dropped: int,
             gc_passes=()) -> dict:
    """Every reading of the span: the request ones (and ``serve.submit``'s
    and ``serve.drain``'s own, to hold them against), the children's cover
    of their parents, with and without the collector's passes
    (``gc_passes``: (generation, start, end) on the ``perf_counter``
    clock), the requests and events counted, and ``dropped``."""
    out = {name: request_ms(events, h0, h1, names, dropped)
           for name, names in REQUEST_SPANS.items()}
    for p in ("serve.submit", "serve.drain"):
        out[f"{p}_ms"] = request_ms(events, h0, h1, (p,), dropped)
    inside = in_span(events, h0, h1)
    passes = [g for g in gc_passes if h0 <= g[1] and g[2] <= h1]
    for p in PARENTS:
        out[f"{p}.children_share"] = child_share(events, h0, h1, p)
        out[f"{p}.children_share_gc_apart"] = child_share(
            events, h0, h1, p, [(a, b) for _, a, b in passes])
    out["gc_passes"] = {str(gen): [sum(1 for g in passes if g[0] == gen),
                                   sum(b - a for g, a, b in passes
                                       if g == gen) * 1e3]
                        for gen in (0, 1, 2)}
    out.update(requests=len(requests(inside)), events=len(inside),
               dropped=dropped,
               deadline_flushes=sum(1 for e in inside
                                    if e["name"] == "serve.deadline_flush"
                                    and e["attrs"].get("work")),
               seconds_by_name=by_name(events, h0, h1))
    return out


def span_cost_us(n: int = 100_000) -> float:
    """Microseconds one recorded span with one attribute costs here, on a
    tracer of its own."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer(maxlen=n)
    tr.enable()
    t0 = time.perf_counter()
    for i in range(n):
        with tr.span("serve.take", req=i):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def armed_profiled(devtrace, tracer):
    """``devtrace.Profiled`` with ``tracer`` cleared and armed from its
    start to its stop, the garbage collector's passes logged over the same
    span, whose reduction adds the program's spans; the last one reduced
    is the class's ``last``, its events, ``dropped`` and ``gc_passes`` on
    it."""

    class ArmedProfiled(devtrace.Profiled):
        last = None

        def start(self) -> None:
            super().start()
            self.gc_passes, self._gc_t0 = [], 0.0
            gc.callbacks.append(self._gc)
            tracer.clear()
            tracer.enable()

        def _gc(self, phase: str, info: dict) -> None:
            now = time.perf_counter()
            if phase == "start":
                self._gc_t0 = now
            else:
                self.gc_passes.append((info["generation"], self._gc_t0, now))

        def stop(self) -> None:
            tracer.disable()
            gc.callbacks.remove(self._gc)
            super().stop()

        def reduce(self, host=()):
            self.events, self.dropped = tracer.events(), tracer.dropped
            type(self).last = self
            return super().reduce(list(host) + host_spans(
                self.events, self.h0, self.h1))

    return ArmedProfiled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from plexbench import devtrace, harness, run
    from repro_torch.obs import TRACE
    run.T_PROC0 = T_PROC0
    armed = armed_profiled(devtrace, TRACE)
    devtrace.Profiled = armed
    kept = {}

    def factory(keys, config, device):
        kept["svc"] = harness.plex_service(keys, config, device)
        return kept["svc"]

    inner = harness.run_cell

    def run_cell(*a, **kw):
        result = inner(*a, service_factory=factory, **kw)
        prof = armed.last
        prog = {} if prof is None else \
            readings(prof.events, prof.h0, prof.h1, prof.dropped,
                     prof.gc_passes)
        stats = kept["svc"].stats
        prog.update(upload_s=kept["svc"].upload_s,
                    timers_started=stats.timers_started,
                    deadline_flushes_total=stats.deadline_flushes,
                    deadline_idle_total=stats.deadline_idle,
                    span_cost_us=span_cost_us())
        result["program"] = prog
        return result

    harness.run_cell = run_cell
    return run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
