"""The program's spans as the benchmark reads them: the request readings
and the children's cover on synthetic events, ``state_upload_s`` on a
synthetic run, an idle gap named by a program span in place of
``client.submit``, the tracer armed only over a profiled span, and the
result's keys on the CPU."""
import gc
import io
import json
import types

import numpy as np
import pytest

from conftest import ROOT
from plexbench import devtrace, harness, spans

SEED = (1 << 31) + 4242


def _ev(eid, name, t0, dur_s, parent=None, **attrs):
    return {"id": eid, "parent": parent, "name": name, "t0": t0,
            "dur_us": dur_s * 1e6, "attrs": attrs}


def _two_requests():
    """Two requests inside [10, 11] s (one's drain answered on another
    thread), one before it; a lookup's dispatch that is not the queue's."""
    return [
        _ev(1, "serve.submit", 9.0, 0.002, req=1),
        _ev(2, "serve.take", 9.0001, 0.001, parent=1, reqs=[1]),
        _ev(10, "serve.submit", 10.1, 0.004, req=2),
        _ev(11, "serve.lock", 10.1001, 0.0005, parent=10, req=2),
        _ev(12, "serve.take", 10.101, 0.001, parent=10, reqs=[2]),
        _ev(13, "serve.staging", 10.102, 0.001, parent=10, reqs=[2]),
        _ev(14, "serve.dispatch", 10.103, 0.0005, parent=10, path="queue",
            reqs=[2]),
        _ev(15, "serve.timer", 10.1036, 0.0003, parent=10, op="start",
            req=2),
        _ev(20, "serve.submit", 10.5, 0.002, req=3),
        _ev(21, "serve.take", 10.5001, 0.001, parent=20, reqs=[3]),
        _ev(22, "serve.dispatch", 10.5012, 0.0005, parent=20, path="queue",
            reqs=[3]),
        _ev(30, "serve.drain", 10.6, 0.003, req=3),
        _ev(31, "serve.drain.wait", 10.6001, 0.001, parent=30, reqs=[3]),
        _ev(32, "serve.copy_back", 10.6012, 0.0012, parent=30, reqs=[3]),
        _ev(33, "serve.fill", 10.6025, 0.0004, parent=30, reqs=[3]),
        _ev(40, "serve.dispatch", 10.7, 0.009, path="stacked"),
    ]


def test_request_readings_on_synthetic_events():
    ev = _two_requests()
    r = spans.readings(ev, 10.0, 11.0, 0)
    assert r["requests"] == 2
    assert r["staging_ms"] == pytest.approx((1 + 1 + 1) / 2)
    assert r["dispatch_ms"] == pytest.approx((0.5 + 0.5) / 2)  # queue only
    assert r["timer_ms"] == pytest.approx(0.3 / 2)
    assert r["lock_wait_ms"] == pytest.approx(0.5 / 2)
    assert r["drain_wait_ms"] == pytest.approx(1.0 / 2)
    assert r["copy_back_ms"] == pytest.approx((1.2 + 0.4) / 2)
    assert r["serve.submit_ms"] == pytest.approx(3.0)
    assert r["serve.submit.children_share"] == pytest.approx(
        (0.5 + 1 + 1 + 0.5 + 0.3 + 1 + 0.5) / 6)
    assert r["serve.drain.children_share"] == pytest.approx(2.6 / 3)
    assert r["serve.deadline_flush.children_share"] is None
    assert r["dropped"] == 0 and r["events"] == len(ev) - 2


def test_request_readings_refuse_a_ring_that_dropped():
    ev = _two_requests()
    for name, names in spans.REQUEST_SPANS.items():
        assert spans.request_ms(ev, 10.0, 11.0, names, 1) is None, name
        assert spans.request_ms([], 10.0, 11.0, names, 0) is None, name
        # no request in the span
        assert spans.request_ms(ev, 11.5, 12.0, names, 0) is None, name


def test_a_span_cut_by_the_tracers_disarm_is_left_out():
    """A span still open at the span's end holds the profiler's stop: it
    counts in no reading, and its children that ended in the span do."""
    ev = _two_requests() + [
        _ev(50, "serve.submit", 10.99, 0.5, req=4),
        _ev(51, "serve.take", 10.991, 0.001, parent=50, reqs=[4])]
    r = spans.readings(ev, 10.0, 11.0, 0)
    assert r["requests"] == 2
    assert r["serve.submit_ms"] == pytest.approx(3.0)
    assert r["staging_ms"] == pytest.approx((1 + 1 + 1 + 1) / 2)
    assert r["events"] == len(ev) - 3


def test_children_share_sets_the_collectors_passes_apart():
    """A pause inside a parent and outside its children leaves the
    parent's time; the part of a pause inside a child stays."""
    ev = [_ev(1, "serve.drain", 10.0, 0.010, req=1),
          _ev(2, "serve.copy_back", 10.0, 0.004, parent=1, reqs=[1]),
          _ev(3, "serve.drain", 10.5, 0.010, req=2),
          _ev(4, "serve.fill", 10.5, 0.010, parent=3, reqs=[2])]
    assert spans.child_share(ev, 10.0, 11.0, "serve.drain") == \
        pytest.approx(0.014 / 0.020)
    pauses = [(10.003, 10.009), (10.501, 10.502), (10.7, 10.8)]
    assert spans.child_share(ev, 10.0, 11.0, "serve.drain", pauses) == \
        pytest.approx(0.014 / (0.020 - 0.005))
    r = spans.readings(ev, 10.0, 11.0, 0, [(2, 10.003, 10.009),
                                            (0, 10.2, 10.2001),
                                            (1, 11.5, 11.6)])
    assert r["serve.drain.children_share_gc_apart"] == \
        pytest.approx(0.014 / 0.015)
    assert r["gc_passes"]["2"] == [1, pytest.approx(6.0)]
    assert r["gc_passes"]["0"][0] == 1 and r["gc_passes"]["1"][0] == 0


def test_state_upload_s_reads_the_programs_own_time():
    read = harness.Bench(ROOT).module("metrics", "state_upload_s").read
    run = types.SimpleNamespace(stats0={"upload_s": 3.25, "queries": 0})
    assert read(run) == 3.25
    run.stats0 = {"queries": 0}        # a program that keeps no such time
    assert read(run) is None


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    # markers at 1,000 and 2,000 us: the span is perf_counter 10-11 s; the
    # card busy 1000-1100 and 1900-2000 us, idle 1100-1900
    return [_x(devtrace.MARK, "user_annotation", 1000.0, 1.0),
            _x(devtrace.MARK, "user_annotation", 2000.0, 1.0),
            _x("k1", "kernel", 1000.0, 100.0),
            _x("k1", "kernel", 1900.0, 100.0)]


def test_an_idle_gap_is_named_by_the_programs_span():
    """``client.submit`` covers the gap; the program's span inside it is
    the innermost host event there, so it names the gap."""
    client = [("client.submit", 10.05, 10.95)]
    s = devtrace.reduce_events(_trace(), 10.0, 11.0, client)
    assert dict(s.idle_gaps) == {"client.submit": pytest.approx(800e-6)}
    prog = spans.host_spans(
        [_ev(1, "serve.submit", 10.08, 0.85, req=1),
         _ev(2, "serve.timer", 10.15, 0.75, parent=1, req=1),
         _ev(3, "serve.fill", 12.0, 0.1)], 10.0, 11.0)   # outside the span
    assert [p[0] for p in prog] == ["serve.submit", "serve.timer"]
    s = devtrace.reduce_events(_trace(), 10.0, 11.0, client + prog)
    assert dict(s.idle_gaps) == {"serve.timer": pytest.approx(800e-6)}


class _StubProfiler:
    """A profiler of nothing whose trace is ``_trace()``."""

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": _trace()}, fh)


def test_the_tracer_is_armed_only_over_the_profiled_span():
    from repro_torch.obs import TRACE
    from repro_torch.serving import PlexService
    keys = np.unique(np.random.default_rng(3).integers(
        0, 1 << 62, 20_000, dtype=np.uint64))
    svc = PlexService(keys, 16, block=512, max_delay_s=60.0, device="cpu",
                      cache_slots=1 << 10)
    armed = spans.armed_profiled(devtrace, TRACE)
    prof = armed.__new__(armed)
    prof.prof, prof.h0, prof.h1 = _StubProfiler(), 0.0, 0.0
    try:
        svc.submit(keys[:512]).result()           # before: not traced
        TRACE.record("stale", 1.0)                # cleared at the start
        prof.start()
        assert TRACE.enabled
        tickets = [svc.submit(keys[i:i + 512]) for i in (0, 512, 1024)]
        for t in tickets:
            t.result()
        gc.collect()                              # a full pass, logged
        prof.stop()
        assert not TRACE.enabled
        assert prof._gc not in gc.callbacks
        svc.submit(keys[:512]).result()           # after: not traced
        prof.reduce([])
    finally:
        svc.close()
        TRACE.disable()
        TRACE.clear()
    assert armed.last is prof and prof.dropped == 0
    assert [g for g, _, _ in prof.gc_passes].count(2) >= 1
    assert spans.requests(prof.events) == {t.id for t in tickets}
    r = spans.readings(prof.events, prof.h0, prof.h1, prof.dropped,
                       prof.gc_passes)
    assert r["requests"] == 3 and r["gc_passes"]["2"][0] >= 1
    for name in spans.REQUEST_SPANS:
        assert r[name] is not None and r[name] >= 0, name
    for p in ("serve.submit", "serve.drain"):
        assert 0 < r[f"{p}.children_share"] <= 1


def _run(root, trace):
    return harness.run_cell(root, "osm-uniform", SEED, 1.0, trace,
                            device="cpu", log=io.StringIO())


def test_the_result_keeps_the_parents_keys_on_the_cpu(small_root):
    """``--trace 0``: the parent's keys and end-to-end metrics, nothing
    more; ``--trace 1``: the new ``state_upload_s`` beside the per-layer
    metrics the CPU reads."""
    res = _run(small_root, False)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"lookups_per_s", "setup_s"}
    assert res["correct"] is True
    res = _run(small_root, True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"build_s", "upload_s", "submit_ms",
                                   "request_p95_ms", "cache_hit_pct",
                                   "state_upload_s"}
    assert 0 < res["metrics"]["state_upload_s"]["value"]
