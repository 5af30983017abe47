"""A profiled span of the window: ``torch.profiler`` over its last seconds
(``harness.TRACE_SPAN_S``), and the reduction of its trace to busy time,
kernel time, the device operations that took most time and the idle gaps
by what the host was doing.

Two markers (``record_function`` ranges on the main thread) anchor the span
in the trace's clock, each at a known ``time.perf_counter`` reading, so the
harness's own request times map into the trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import os
import tempfile
import time

import numpy as np

MARK = "plexbench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")   # and the CUDA API ("cuda_*")
TOP = 10


def _profile():
    """A profiler of the CPU and the card; every thread's host operations
    where this PyTorch can record them (``profile_all_threads``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


def warm() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls in set-up, not in the window."""
    import torch
    with _profile():
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@dataclasses.dataclass
class Span:
    """What the trace of one span holds, in seconds."""
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list
    idle_gaps: list
    h0: float                  # perf_counter at the span's start and end
    h1: float


class Profiled:
    """Profile from ``start()`` to ``stop()``, then ``reduce()``."""

    def __init__(self):
        self.prof = _profile()
        self.h0 = self.h1 = 0.0

    def _mark(self) -> float:
        from torch.profiler import record_function
        h = time.perf_counter()
        with record_function(MARK):
            pass
        return h

    def start(self) -> None:
        self.prof.start()
        self.h0 = self._mark()

    def stop(self) -> None:
        self.h1 = self._mark()
        self.prof.stop()

    def reduce(self, host_spans=()) -> Span:
        """The span's numbers. ``host_spans``: (name, perf_counter start,
        end) of what the harness's clients were doing, which name an idle
        gap where the trace holds no host operation of those threads."""
        fd, path = tempfile.mkstemp(prefix="plexbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            with contextlib.suppress(OSError):
                os.unlink(path)
        return reduce_events(events, self.h0, self.h1, host_spans)


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) intervals of ``iv`` ([n, 2])."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _innermost(gaps: np.ndarray, host: list) -> list:
    """Name of the shortest host event active at each gap's midpoint
    (``"none"`` where no host event is), by one sweep in time order."""
    host = sorted(host, key=lambda e: e[0])
    names, heap, k = [], [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while k < len(host) and host[k][0] <= mid:
            s, e, name = host[k]
            heapq.heappush(heap, (e - s, e, name))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        # an ended event below the top is popped once it surfaces; the
        # top is active, and the shortest of the active ones
        names.append(heap[0][2] if heap else "none")
    return names


def reduce_events(events: list, h0: float, h1: float,
                  host_spans=()) -> Span:
    marks = sorted(e["ts"] for e in events
                   if e.get("ph") == "X" and e.get("name") == MARK)
    if len(marks) < 2:
        raise RuntimeError("the trace lacks the span's two markers")
    a0, a1 = marks[0], marks[-1]

    def to_trace(h: float) -> float:     # perf_counter s -> trace us
        return a0 + (h - h0) * (a1 - a0) / (h1 - h0)

    dev, by_name, kernel_us = [], {}, 0.0
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, t = max(s, a0), min(t, a1)
            if t <= s:
                continue
            dev.append((s, t))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
            if cat == "kernel":
                kernel_us += t - s
        elif (cat in HOST_CATS or cat.startswith("cuda_")) and \
                e.get("name") != MARK:
            host.append((s, t, e["name"]))
    host += [(to_trace(s), to_trace(t), name) for name, s, t in host_spans]
    busy = _union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())
    edges = np.concatenate([[a0], busy.ravel(), [a1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle: dict[str, float] = {}
    for (g0, g1), name in zip(gaps, _innermost(gaps, host)):
        idle[name] = idle.get(name, 0.0) + (g1 - g0)

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Span(window_s=h1 - h0, busy_s=busy_us / 1e6,
                kernel_s=kernel_us / 1e6, device_ops=top(by_name),
                idle_gaps=top(idle), h0=h0, h1=h1)
