"""Observability of the port: the metrics registry, span tracing, the live
shard-hotness export, the flight recorder, the SLO watchdog and incident
bundles — ``tests/test_obs.py``'s tests whose subject the port has (every
one but the benchmarks' helpers), then parity with
the reference on the same operations.

The port's ``PlexService`` runs with ``device="cpu"`` (the ``cuda``
backend is K1's plain version there, ``torch`` the plain pipeline); where
the reference names ``jnp`` the port names ``torch``, and ``pallas``
becomes ``cuda``. Parity: the same instrument operations give
byte-identical Prometheus text; the same service operations emit the same
span sequence with the same non-timing attributes, and the same incident
kinds and bundle files under injected faults; the same health samples on
the same fake clock give the same SLO status. The drill
``python -m repro_torch.launch.observe`` runs at a small size on the CPU.
"""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.obs as R
from repro.obs import incident as r_incident_mod
from repro.obs.export import prometheus_text as r_prometheus_text
from repro.obs.slo import SLOSpec as RSLOSpec
from repro.obs.slo import SLOWatchdog as RSLOWatchdog
from repro.obs.slo import default_slos as r_default_slos
from repro.resilience import FAULTS as RFAULTS
from repro.resilience import always as r_always
from repro.resilience import fail_once as r_fail_once
from repro.serving import PlexService as RService
from repro_torch.obs import (METRICS, TRACE, disable_observability,
                             enable_observability, observability_enabled)
from repro_torch.obs import incident as incident_mod
from repro_torch.obs.export import prometheus_text, write_jsonl
from repro_torch.obs.metrics import RING_SIZE, Histogram, MetricsRegistry
from repro_torch.obs.recorder import RECORDER, FlightRecorder
from repro_torch.obs.slo import SLOSpec, SLOWatchdog, default_slos
from repro_torch.obs.trace import Tracer, _NULL
from repro_torch.resilience import FAULTS
from repro_torch.serving.plex_service import PlexService as _PortService
from repro_torch.serving.plex_service import ServiceStats

ROOT = pathlib.Path(__file__).resolve().parents[1]


def PlexService(keys, eps=64, **kw):
    """The port's service on the CPU (the reference's tests run on it)."""
    kw.setdefault("device", "cpu")
    return _PortService(keys, eps, **kw)


def _reset_all():
    for mod, inc in ((sys.modules["repro_torch.obs"], incident_mod),
                     (R, r_incident_mod)):
        if mod.RECORDER.armed:
            mod.RECORDER.disarm()
        mod.RECORDER.clear()
        inc.uninstall()
        mod.disable_observability()
        mod.METRICS.reset()
        mod.METRICS.counted_dispatch = True
        mod.TRACE.clear()
        mod.TRACE.sample_n = 1
    FAULTS.reset()
    RFAULTS.reset()


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends disarmed with empty instruments (both
    packages' singletons are process-global, like the fault registries)."""
    _reset_all()
    yield
    _reset_all()


def _keys(n: int = 50_000, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 2**62, n, dtype=np.uint64))


# -- registry primitives -----------------------------------------------------

def test_disabled_by_default_and_null_span_shared():
    assert not observability_enabled()
    assert TRACE.span("x") is _NULL
    assert TRACE.span("y", a=1) is _NULL     # attrs never allocate a span
    TRACE.record("x", 1.0)
    TRACE.event("x")
    assert TRACE.events() == []


def test_registry_counters_gauges_vectors():
    r = MetricsRegistry()
    c = r.counter("a.b")
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    assert r.counter("a.b") is c             # get-or-create returns shared
    r.gauge("g").set(2.5)
    v = r.vector("shards", 4)
    v.add(np.asarray([1, 2, 3, 4]))
    v.add_at(0, 10)
    assert v.snapshot() == [11, 2, 3, 4]
    with pytest.raises(ValueError, match="shape"):
        v.add(np.zeros(3))
    # a length change replaces (epoch-scoped per-shard planes)
    v2 = r.vector("shards", 6)
    assert v2 is not v and v2.snapshot() == [0] * 6
    snap = r.snapshot()
    assert snap["counters"]["a.b"] == 5
    assert snap["gauges"]["g"] == 2.5
    json.dumps(snap)                          # JSON-serialisable contract


def test_histogram_percentiles_and_ring_wrap():
    h = Histogram("lat")
    for v in range(1, 1001):
        h.observe(float(v))
    assert h.count == 1000 and h.max == 1000.0
    assert h.percentile(0.50) == 500.0
    assert h.percentile(0.99) == 990.0
    assert h.percentile(0.0) == 1.0
    # wrap the ring: the recent window forgets the first samples
    for v in range(RING_SIZE):
        h.observe(10_000.0)
    assert h.percentile(0.50) == 10_000.0
    assert h.count == 1000 + RING_SIZE        # totals stay cumulative
    buckets = h.bucket_counts()
    assert buckets[-1][0] == float("inf")
    assert buckets[-1][1] == h.count          # cumulative ends at total
    snap = h.snapshot()
    assert set(snap) == {"count", "sum", "max", "p50", "p90", "p99"}


def test_tracer_nesting_record_event_jsonl():
    tr = Tracer()
    tr.enable()
    with tr.span("outer", n=2):
        with tr.span("inner"):
            pass
    tr.record("posthoc", 0.5, shard=1)
    tr.event("marker", state="open")
    evs = tr.events()
    by = {e["name"]: e for e in evs}
    assert by["inner"]["depth"] == 1 and by["outer"]["depth"] == 0
    # inner exits (and emits) before outer
    assert evs.index(by["inner"]) < evs.index(by["outer"])
    assert by["posthoc"]["dur_us"] == pytest.approx(5e5)
    assert by["marker"]["dur_us"] == 0.0
    assert by["outer"]["attrs"]["n"] == 2
    for line in tr.to_jsonl().splitlines():
        json.loads(line)


def test_prometheus_text_format():
    r = MetricsRegistry()
    r.counter("wal.append_records").inc(3)
    r.histogram("serve.lookup_us").observe(5.0)
    r.vector("serve.shard.routed", 2).add(np.asarray([7, 9]))
    text = prometheus_text(r, prefix="plex")
    assert "plex_wal_append_records_total 3" in text
    assert 'plex_serve_shard_routed_total{shard="0"} 7' in text
    assert "# TYPE plex_serve_lookup_us histogram" in text
    assert 'plex_serve_lookup_us_bucket{le="+Inf"} 1' in text
    assert "plex_serve_lookup_us_count 1" in text
    # recent-window quantiles live in their own gauge family: a bare
    # {quantile=...} sample under the histogram name is invalid exposition
    assert "# TYPE plex_serve_lookup_us_recent gauge" in text
    assert 'plex_serve_lookup_us_recent{quantile="0.5"} 5' in text
    assert 'plex_serve_lookup_us{quantile' not in text


def _parse_prometheus(text: str) -> dict[str, dict]:
    """Minimal exposition parser: family -> {type, samples: [(name,
    labels, value)]}. Raises on malformed lines or samples that belong
    to no declared family."""
    fams: dict[str, dict] = {}
    hist_suffixes = ("_bucket", "_sum", "_count")
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, fam, typ = line.split(" ")
            assert fam not in fams, f"duplicate TYPE for {fam}"
            fams[fam] = {"type": typ, "samples": []}
            continue
        assert not line.startswith("#"), f"unexpected comment: {line}"
        metric, value = line.rsplit(" ", 1)
        labels = ""
        if "{" in metric:
            metric, _, rest = metric.partition("{")
            labels = rest.rstrip("}")
        owner = None
        if metric in fams:
            owner = metric
            if fams[metric]["type"] == "histogram":
                # a bare sample under a histogram family is invalid
                raise AssertionError(f"bare sample under histogram "
                                     f"family: {line}")
        else:
            for suf in hist_suffixes:
                base = metric[:-len(suf)] if metric.endswith(suf) else None
                if base in fams and fams[base]["type"] == "histogram":
                    owner = base
                    break
        assert owner is not None, f"sample outside any TYPE family: {line}"
        fams[owner]["samples"].append((metric, labels, float(value)))
    return fams


def test_prometheus_format_validity():
    """Whole-page validity: unique TYPE per family, every sample owned by
    a declared family, histogram buckets cumulative and ending at +Inf
    == _count."""
    r = MetricsRegistry()
    r.counter("serve.dispatch.cuda").inc(4)
    r.gauge("queue.depth").set(7)
    for v in (3.0, 30.0, 300.0, 3e6):
        r.histogram("serve.lookup_us").observe(v)
    r.vector("serve.shard.routed", 3).add(np.asarray([1, 2, 3]))
    fams = _parse_prometheus(prometheus_text(r))
    h = fams["plex_serve_lookup_us"]
    assert h["type"] == "histogram"
    buckets = [(lab, v) for m, lab, v in h["samples"]
               if m.endswith("_bucket")]
    counts = [v for _, v in buckets]
    assert counts == sorted(counts), "le buckets must be cumulative"
    assert buckets[-1][0] == 'le="+Inf"'
    count = [v for m, _, v in h["samples"] if m.endswith("_count")][0]
    assert buckets[-1][1] == count == 4
    assert fams["plex_serve_lookup_us_recent"]["type"] == "gauge"
    assert fams["plex_serve_dispatch_cuda_total"]["type"] == "counter"
    assert len(fams["plex_serve_shard_routed_total"]["samples"]) == 3


def test_scrape_during_registration_race():
    """Exporters and ``snapshot()`` iterate via the locked ``collect()``:
    concurrent instrument registration against scrapes and snapshots
    raises nothing, and every page parses."""
    r = MetricsRegistry()
    stop = threading.Event()
    errors: list[BaseException] = []

    def registrar(tid: int):
        i = 0
        while not stop.is_set():
            r.counter(f"c.{tid}.{i}").inc()
            r.gauge(f"g.{tid}.{i}").set(i)
            r.histogram(f"h.{tid}.{i}").observe(float(i + 1))
            r.vector(f"v.{tid}.{i}", 2).add_at(0)
            i += 1

    def scraper():
        while not stop.is_set():
            try:
                _parse_prometheus(prometheus_text(r))
                json.dumps(r.snapshot())
            except BaseException as e:   # pragma: no cover - the bug
                errors.append(e)
                return

    threads = [threading.Thread(target=registrar, args=(t,))
               for t in range(2)] + \
        [threading.Thread(target=scraper) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors


def test_write_jsonl_spans_then_metrics(tmp_path):
    enable_observability()
    with TRACE.span("serve.lookup", n=1):
        METRICS.counter("c").inc()
    disable_observability()
    path = write_jsonl(tmp_path / "events.jsonl")
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["type"] == "span" and lines[0]["name"] == "serve.lookup"
    assert lines[-1]["type"] == "metrics" and lines[-1]["counters"]["c"] == 1


# -- counted dispatch: parity + exact hotness --------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_counted_dispatch_bit_identical(backend):
    """Arming METRICS must never change a result on any stacked backend
    (the counted pipeline is the same math over the same planes)."""
    keys = _keys(30_000)
    svc = PlexService(keys, 32, n_shards=4, backend=backend)
    try:
        q = np.random.default_rng(0).choice(keys, 4000)
        off = svc.lookup(q)
        enable_observability()
        on = svc.lookup(q)
        assert np.array_equal(off, on)
        assert np.array_equal(on, np.searchsorted(keys, q, "left"))
    finally:
        svc.close()


def test_live_hotness_is_exact_bincount():
    keys = _keys()
    svc = PlexService(keys, 32, n_shards=4)
    try:
        assert svc.live_hotness().tolist() == [0, 0, 0, 0]
        rng = np.random.default_rng(1)
        enable_observability()
        q1 = rng.choice(keys, 6000)
        q2 = rng.choice(keys, 3000)
        svc.lookup(q1)
        svc.lookup(q2)
        want = (np.bincount(svc.route(q1), minlength=4)
                + np.bincount(svc.route(q2), minlength=4))
        assert np.array_equal(svc.live_hotness(), want)
        # probe trips: every counted query lands in exactly one bucket
        assert svc.probe_trip_hist().sum() == 9000
        # the registry mirror agrees
        assert METRICS.vector("serve.shard.routed", 4).snapshot() == \
            want.tolist()
        assert METRICS.counter("serve.routed_queries").snapshot() == 9000
    finally:
        svc.close()


def test_hotness_counts_merged_delta_and_queue_paths():
    keys = _keys(40_000)
    svc = PlexService(keys, 32, n_shards=4, merge_threshold=0)
    try:
        fresh = np.unique(np.random.default_rng(2).integers(
            0, 2**62, 500, dtype=np.uint64))
        svc.insert(fresh)                    # pending delta: merged path
        model = svc.logical_keys()
        rng = np.random.default_rng(3)
        q = np.asarray(model)[rng.integers(0, model.size, 5000)]
        enable_observability()
        got = svc.lookup(q)                  # merged counted dispatch
        assert np.array_equal(got, np.searchsorted(model, q, "left"))
        t = svc.submit(q[:2000])             # queue path counts too
        svc.drain()
        np.testing.assert_array_equal(
            t.result(), np.searchsorted(model, q[:2000], "left"))
        want = (np.bincount(svc.route(q), minlength=4)
                + np.bincount(svc.route(q[:2000]), minlength=4))
        assert np.array_equal(svc.live_hotness(), want)
    finally:
        svc.close()


def test_hotness_resets_at_merge_epoch():
    keys = _keys(40_000)
    svc = PlexService(keys, 32, n_shards=4, merge_threshold=256)
    try:
        enable_observability()
        rng = np.random.default_rng(4)
        svc.lookup(rng.choice(keys, 3000))
        assert svc.live_hotness().sum() == 3000
        fresh = np.unique(rng.integers(0, 2**62, 600, dtype=np.uint64))
        svc.insert(fresh)                    # crosses threshold: sync merge
        assert svc.stats.merges == 1
        assert svc.live_hotness().sum() == 0  # per-epoch estimate restarts
        model = svc.logical_keys()
        q = np.asarray(model)[rng.integers(0, model.size, 2000)]
        svc.lookup(q)
        assert np.array_equal(svc.live_hotness(),
                              np.bincount(svc.route(q), minlength=4))
    finally:
        svc.close()


def test_host_backend_hotness_fold():
    keys = _keys(30_000)
    svc = PlexService(keys, 32, n_shards=4, backend="numpy")
    try:
        enable_observability()
        q = np.random.default_rng(5).choice(keys, 4000)
        svc.lookup(q)
        assert np.array_equal(svc.live_hotness(),
                              np.bincount(svc.route(q), minlength=4))
        # the host path routes without probing: no probe trips
        assert svc.probe_trip_hist().sum() == 0
    finally:
        svc.close()


@pytest.mark.parametrize("n_slots", [1, 4])
def test_routed_mesh_hotness(n_slots):
    """The routed path (``plan=``, slots repeating the CPU): each slot's
    counter plane folds at its first shard's global offset, so the live
    hotness equals ``np.bincount(svc.route(q))`` and the reference's
    ``plan=1`` service's; the routed dispatch and sync spans carry
    ``path="routed"``."""
    keys = _keys(40_000)
    svc = PlexService(keys, 32, n_shards=4, plan=n_slots,
                      devices=[torch.device("cpu")] * n_slots)
    rsvc = RService(keys, 32, n_shards=4, plan=1)
    try:
        assert svc.plan is not None and svc.plan.n_devices == n_slots
        enable_observability()
        R.enable_observability()
        q = np.random.default_rng(6).choice(keys, 5000)
        got = svc.lookup(q)
        assert np.array_equal(got, np.searchsorted(keys, q, "left"))
        assert np.array_equal(got, rsvc.lookup(q, backend="jnp"))
        want = np.bincount(svc.route(q), minlength=4)
        assert np.array_equal(svc.live_hotness(), want)
        assert np.array_equal(rsvc.live_hotness(), want)
        routed = [e for e in TRACE.events()
                  if e["name"] in ("serve.dispatch", "serve.sync")]
        assert [e["attrs"]["path"] for e in routed] == ["routed"] * 2
    finally:
        svc.close()
        rsvc.close()


def test_placement_plan_event_and_counters_parity():
    """A (re)plan records the reference's ``placement.plan`` event and
    ``placement.*`` instruments, attribute for attribute."""
    from repro.core import Snapshot as RSnap
    from repro.distrib import plan_placement as r_plan_placement
    from repro_torch.core import Snapshot
    from repro_torch.distrib import plan_placement
    keys = _keys(30_000)
    enable_observability()
    R.enable_observability()
    plan_placement(Snapshot.build(keys.copy(), 32, n_shards=5,
                                  device="cpu"), 3)
    r_plan_placement(RSnap.build(keys.copy(), 32, n_shards=5), 3)
    ev = [e for e in TRACE.events() if e["name"] == "placement.plan"]
    rev = [e for e in R.TRACE.events() if e["name"] == "placement.plan"]
    assert len(ev) == len(rev) == 1
    assert ev[0]["attrs"] == rev[0]["attrs"]
    snap, rsnap = METRICS.snapshot(), R.METRICS.snapshot()
    for kind in ("counters", "gauges"):
        mine = {k: v for k, v in snap[kind].items()
                if k.startswith("placement.")}
        assert mine and mine == {k: v for k, v in rsnap[kind].items()
                                 if k.startswith("placement.")}


# -- spans through the pipeline ----------------------------------------------

def test_serve_spans_cover_pipeline_stages():
    keys = _keys()
    enable_observability()
    svc = PlexService(keys, 32, n_shards=2)
    try:
        q = np.random.default_rng(7).choice(keys, 6000)
        svc.lookup(q)
        t = svc.submit(q[:1000])
        svc.drain()
        t.result()
        names = TRACE.span_names()
        for need in ("serve.lookup", "serve.staging", "serve.dispatch",
                     "serve.sync", "serve.submit", "serve.queue_wait",
                     "serve.drain", "serve.new_state", "serve.lock",
                     "serve.take", "serve.timer", "serve.drain.wait",
                     "serve.copy_back", "serve.cache_count", "serve.fill"):
            assert need in names, f"missing span {need}: {sorted(names)}"
        assert len(names) >= 6
        evs = TRACE.events()
        # the constructor's upload, as kept whether traced or not
        new_state = [e for e in evs if e["name"] == "serve.new_state"]
        assert len(new_state) == 1
        assert new_state[0]["dur_us"] == pytest.approx(svc.upload_s * 1e6,
                                                       abs=1e-3)
        # every event is a child of the span open on its thread, and the
        # queue's spans are tied to the ticket
        by_id = {e["id"]: e for e in evs}
        for e in evs:
            if e["parent"] is not None:
                assert e["parent"] in by_id
                assert by_id[e["parent"]]["depth"] == e["depth"] - 1
            else:
                assert e["depth"] == 0
        for e in evs:
            if e["name"] in ("serve.submit", "serve.take", "serve.fill"):
                a = e["attrs"]
                assert a.get("req") == t.id or t.id in a.get("reqs", ())
        # lookup latency histograms observed per call
        assert METRICS.histogram("serve.lookup_us").count >= 1
        assert METRICS.histogram("serve.lookup_ns_per_key") \
            .percentile(0.99) > 0
    finally:
        svc.close()


def test_merge_wal_build_spans(tmp_path):
    keys = _keys(30_000)
    svc = PlexService(keys, 32, n_shards=2)
    root = tmp_path / "svc"
    svc.save(root)
    svc.close()
    enable_observability()
    svc = _PortService.open(root, backend="torch", merge_threshold=128,
                            device="cpu")
    try:
        fresh = np.unique(np.random.default_rng(8).integers(
            0, 2**62, 300, dtype=np.uint64))
        svc.insert(fresh)                    # WAL append + sync merge
        names = TRACE.span_names()
        for need in ("persist.open", "wal.append", "merge.capture",
                     "merge.build", "merge.publish", "build.shard",
                     "build.spline", "build.tune", "build.layer"):
            assert need in names, f"missing span {need}: {sorted(names)}"
        assert METRICS.counter("merge.cycles").snapshot() == 1
        assert METRICS.counter("wal.append_records").snapshot() >= 1
        assert METRICS.counter("wal.append_bytes").snapshot() > 0
    finally:
        svc.close()


def test_breaker_transition_events():
    from repro_torch.resilience.breakers import CircuitBreaker
    enable_observability()
    br = CircuitBreaker("b", failure_threshold=2, cooldown_s=0.0)
    br.record_failure(RuntimeError("x"))
    assert [e for e in TRACE.events()
            if e["name"] == "breaker.transition"] == []
    br.record_failure(RuntimeError("x"))     # threshold: closed -> open
    assert br.allow()                        # cooldown 0: half-open probe
    br.record_success()                      # probe ok: -> closed
    evs = [e for e in TRACE.events() if e["name"] == "breaker.transition"]
    assert [(e["attrs"]["frm"], e["attrs"]["to"]) for e in evs] == \
        [("closed", "open"), ("half_open", "closed")]
    assert METRICS.counter("breaker.b.to_open").snapshot() == 1


# -- health schema + stats thread-safety -------------------------------------

def test_health_schema_pinned_and_json():
    keys = _keys(20_000)
    svc = PlexService(keys, 32, n_shards=2)
    try:
        h = svc.health()
        assert set(h) == {
            "generation", "epoch", "n_keys", "n_pending", "routed_devices",
            "fallback_chain", "breakers", "degraded", "queue_depth",
            "queue_limit", "inflight_batches", "timers_started",
            "deadline_threads",
            "deadline_flushes", "deadline_idle", "shed_queries",
            "backend_failures", "fallback_lookups", "merge_failures",
            "merge_retry_in_s", "merge_backlog_s", "merge_mode",
            "merge_worker_alive", "journal_ops", "wal_bytes",
            "last_errors", "armed_faults", "closed", "metrics",
        }
        assert set(h["metrics"]) == {
            "enabled", "shard_hotness", "probe_trips", "cache_hits",
            "cache_queries", "full_hit_batches", "registry",
        }
        assert h["metrics"]["enabled"] is False
        json.dumps(h)
        enable_observability()
        svc.lookup(keys[:100])
        json.dumps(svc.health())             # armed snapshot serialises too
    finally:
        svc.close()


def test_health_json_after_chaos_fallback():
    from repro_torch.resilience.faults import POINT_BACKEND_DISPATCH, always
    keys = _keys(20_000)
    svc = PlexService(keys, 32, n_shards=2, backend="torch",
                      breaker_threshold=1)
    try:
        enable_observability()
        with FAULTS.injected(POINT_BACKEND_DISPATCH,
                             always(backend="torch")):
            q = keys[:500]
            got = svc.lookup(q)              # degrades to numpy, stays exact
            assert np.array_equal(got, np.searchsorted(keys, q, "left"))
        h = svc.health()
        assert h["degraded"] and h["fallback_lookups"] >= 1
        json.dumps(h)
    finally:
        svc.close()


def test_stats_epoch_rollover_race_free():
    """note_cache_synced vs new_epoch: a stale-epoch fold must be dropped
    atomically, and concurrent folds must never be lost. Hammer the pair
    from threads and check exact conservation."""
    stats = ServiceStats()
    stats.new_epoch(0)
    applied = [0]
    stop = threading.Event()

    def roller():
        e = 0
        while not stop.is_set():
            e += 1
            stats.new_epoch(e)
            time.sleep(0)

    def writer():
        n = 0
        while not stop.is_set():
            if stats.note_cache_synced(1, 2, False, stats.epoch):
                n += 1
        applied[0] += n

    threads = [threading.Thread(target=roller)] + \
        [threading.Thread(target=writer) for _ in range(4)]
    for t in threads[1:]:
        t.start()
    threads[0].start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    final_epoch = stats.epoch
    stats.new_epoch(final_epoch)             # roll once more: counters zero
    assert stats.cache_queries == 0 and stats.cache_hits == 0
    assert applied[0] > 0                    # some folds landed


def test_background_merge_with_obs_stress():
    """Writer inserts past the threshold while readers serve with obs
    armed: final lookups stay exact, health stays JSON-serialisable, and
    the per-epoch live hotness matches the current shard count. A scraper
    thread exports Prometheus text throughout while the merge worker
    registers instruments (``merge.cycles``) concurrently."""
    keys = _keys(40_000)
    svc = PlexService(keys.copy(), 32, n_shards=2, backend="numpy",
                      merge_mode="background", merge_threshold=256)
    errors: list[BaseException] = []
    stop = threading.Event()
    try:
        enable_observability()
        rng = np.random.default_rng(9)

        def reader():
            r = np.random.default_rng(10)
            while not stop.is_set():
                model = svc.logical_keys()
                q = np.asarray(model)[r.integers(0, model.size, 500)]
                try:
                    got = svc.lookup(q)
                    want = np.searchsorted(model, q, "left")
                    # a concurrent merge may publish between the capture
                    # and the lookup; exactness is re-checked at the end
                    if got.shape != want.shape:
                        raise AssertionError("shape drift")
                except Exception as e:       # pragma: no cover
                    errors.append(e)
                    return

        def scraper():
            while not stop.is_set():
                try:
                    prometheus_text()
                    json.dumps(METRICS.snapshot())
                except Exception as e:       # pragma: no cover
                    errors.append(e)
                    return

        readers = [threading.Thread(target=reader) for _ in range(2)] + \
            [threading.Thread(target=scraper)]
        for t in readers:
            t.start()
        for _ in range(4):
            svc.insert(np.unique(rng.integers(0, 2**62, 300,
                                              dtype=np.uint64)))
            time.sleep(0.02)
        deadline = time.monotonic() + 30.0
        while svc.n_pending and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in readers:
            t.join()
        assert not errors, errors
        model = svc.logical_keys()
        q = np.asarray(model)[::29]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(model, q, "left"))
        assert svc.live_hotness().size == svc.n_shards
        json.dumps(svc.health())
    finally:
        stop.set()
        svc.close()


# -- tracer robustness under the always-on mode ------------------------------

def test_span_mismatched_exit_restores_depth():
    """Out-of-order exits (outer before inner) must truncate the stale
    frames, not leak them into every later span's depth."""
    tr = Tracer()
    tr.enable()
    a = tr.span("a")
    b = tr.span("b")
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)     # exits while b is still on the stack
    b.__exit__(None, None, None)     # stale frame: must not corrupt depth
    with tr.span("after") as s:
        assert s._depth == 0
    assert tr._stack() == []


def test_span_exception_crossed_exit_restores_depth():
    """A generator-held span abandoned by an exception must not inflate
    depth once the enclosing span exits."""
    tr = Tracer()
    tr.enable()

    def gen():
        with tr.span("leaky"):
            yield 1
            yield 2                  # never reached: span never exits

    with pytest.raises(RuntimeError):
        with tr.span("outer"):
            g = gen()
            next(g)
            del g                    # leaky's frame is now stale
            raise RuntimeError("boom")
    # outer's truncating exit swept the abandoned inner frame with it
    with tr.span("after") as s:
        assert s._depth == 0
    assert tr._stack() == []


def test_trace_cross_thread_interleave_and_soak():
    """record()/event() from sampler/worker-style threads interleave
    safely at the deque, and a long soak holds the bounded-memory
    contract (newest maxlen events kept)."""
    tr = Tracer(maxlen=1024)
    tr.enable()
    errors: list[BaseException] = []

    def hammer(tid: int):
        try:
            for i in range(5000):
                tr.record(f"t{tid}.r", 1e-6, i=i)
                tr.event(f"t{tid}.e", i=i)
                with tr.span(f"t{tid}.s"):
                    pass
        except BaseException as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    evs = tr.events()
    assert len(evs) == 1024          # soak: bounded, newest kept
    for line in tr.to_jsonl().splitlines():
        json.loads(line)
    # per-thread depths never bled across threads
    assert all(e["depth"] == 0 for e in evs)


def test_span_sampling_keeps_one_in_n():
    tr = Tracer()
    tr.enable()
    tr.sample_n = 4
    for _ in range(100):
        with tr.span("s"):
            pass
    for _ in range(100):
        tr.record("r", 1e-6)
    for _ in range(10):
        tr.event("e")                # events are never sampled
    names = [e["name"] for e in tr.events()]
    assert names.count("s") == 25
    assert names.count("r") == 25
    assert names.count("e") == 10
    tr.sample_n = 1
    tr.clear()
    with tr.span("t"):
        pass
    assert len(tr.events()) == 1     # back to full fidelity


def test_ids_parents_and_the_perf_counter_start():
    tr = Tracer()
    tr.enable()
    t_before = time.perf_counter()
    with tr.span("root") as root:
        with tr.span("child") as child:
            tr.record("rec", 1e-6)
            tr.event("mark")
        with tr.span("sibling"):
            pass
    tr.record("alone", 1e-6)
    t_after = time.perf_counter()
    by = {e["name"]: e for e in tr.events()}
    assert by["root"]["id"] == root.id and by["child"]["id"] == child.id
    assert len({e["id"] for e in by.values()}) == len(by)   # unique
    assert by["root"]["parent"] is None and by["alone"]["parent"] is None
    assert by["child"]["parent"] == by["sibling"]["parent"] == root.id
    assert by["rec"]["parent"] == by["mark"]["parent"] == child.id
    # t0 is the perf_counter start: inside the test's readings, children
    # inside their parent, and ts is the same instant in epoch seconds
    for e in by.values():
        assert t_before <= e["t0"] <= t_after
        assert e["ts"] - e["t0"] == pytest.approx(tr._wall_offset,
                                                  abs=2e-6)
    for name in ("child", "sibling"):
        e, p = by[name], by["root"]
        assert p["t0"] <= e["t0"]
        assert e["t0"] + e["dur_us"] / 1e6 <= \
            p["t0"] + p["dur_us"] / 1e6 + 1e-6
    assert by["child"]["t0"] < by["sibling"]["t0"]         # monotonic
    ts = [e["t0"] for e in tr.events() if e["name"] in ("root", "alone")]
    assert ts == sorted(ts)


def test_dropped_counts_the_ring_overflow():
    tr = Tracer(maxlen=8)
    tr.enable()
    for i in range(20):
        with tr.span("s", i=i):
            pass
    assert len(tr.events()) == 8 and tr.dropped == 12
    assert [e["attrs"]["i"] for e in tr.events()] == list(range(12, 20))
    tr.clear()
    assert tr.dropped == 0 and tr.events() == []
    tr.record("r", 1e-6)
    assert tr.dropped == 0


def test_sampling_keeps_or_drops_a_whole_tree():
    """Under ``sample_n = 4`` the decision is the root's: each kept root
    comes with all its children and records, a dropped one with none;
    events are kept either way, as roots' children only when kept."""
    tr = Tracer()
    tr.enable()
    tr.sample_n = 4
    for i in range(40):
        with tr.span("req", i=i):
            with tr.span("child", i=i):
                tr.record("rec", 1e-6, i=i)
            tr.event("mark", i=i)
    evs = tr.events()
    kept = {e["attrs"]["i"] for e in evs if e["name"] == "req"}
    assert len(kept) == 10
    for name in ("child", "rec"):
        assert {e["attrs"]["i"] for e in evs if e["name"] == name} == kept
    marks = [e for e in evs if e["name"] == "mark"]
    assert len(marks) == 40                  # events are never sampled
    roots = {e["id"]: e["attrs"]["i"] for e in evs if e["name"] == "req"}
    for m in marks:
        if m["attrs"]["i"] in kept:
            assert roots[m["parent"]] == m["attrs"]["i"]
        else:
            assert m["parent"] is None
    assert tr._stack() == []                 # the skip markers unwound


def test_disabled_serving_sites_build_no_span_and_no_ids_list(
        monkeypatch):
    """Tracing off, a served request's span sites (submit, the block's
    take, staging and dispatch, the timer, the drain and its children, a
    deadline flush) return the shared null span: no span object and no
    list of request ids is built, and nothing is recorded. The request
    ids themselves are always assigned."""
    import repro_torch.obs.trace as trace_mod
    import repro_torch.serving.plex_service as ps
    built = []
    monkeypatch.setattr(trace_mod, "_Span",
                        lambda *a: built.append(a[1:]))
    monkeypatch.setattr(ps, "_reqs", lambda pieces: built.append(pieces))
    keys = _keys(20_000)
    svc = PlexService(keys, 32, block=512, max_delay_s=0.02,
                      cache_slots=1 << 10)
    try:
        t1 = svc.submit(keys[:300])
        deadline = time.monotonic() + 5.0
        while not t1.ready and time.monotonic() < deadline:
            time.sleep(0.005)            # the timer thread flushes it
        t2 = svc.submit(keys[300:1324])  # two whole blocks
        assert np.array_equal(t2.result(), np.arange(300, 1324))
        assert np.array_equal(t1.result(), np.arange(300))
        assert svc.stats.deadline_flushes >= 1
        assert (t1.id, t2.id) == (1, 2)
    finally:
        svc.close()
    assert built == [] and TRACE.events() == []
    assert TRACE.span("serve.take", lanes=1) is _NULL


# -- flight recorder ---------------------------------------------------------

def test_recorder_arm_disarm_and_series():
    rec = FlightRecorder(interval_s=3600.0)   # thread effectively idle
    rec.arm(span_sample=8)
    try:
        assert METRICS.enabled and TRACE.enabled and TRACE.sample_n == 8
        # sampled posture: K1's uncounted variant while armed
        assert not METRICS.counted_dispatch
        METRICS.counter("serve.lookups").inc(5)
        METRICS.gauge("queue.depth").set(3.0)
        h = METRICS.histogram("serve.lookup_ns_per_key")
        for v in (100.0, 200.0, 900.0):
            h.observe(v)
        rec.tick(now=1.0)
        METRICS.counter("serve.lookups").inc(2)
        rec.tick(now=2.0)
        assert rec.series("counter.serve.lookups") == [(1.0, 5.0),
                                                       (2.0, 7.0)]
        assert rec.series("gauge.queue.depth")[-1] == (2.0, 3.0)
        assert rec.series("hist.serve.lookup_ns_per_key.count")[-1][1] == 3
        snap = rec.snapshot()
        json.loads(json.dumps(snap))            # bundle payload round-trips
        assert snap["ticks"] == 2 and snap["span_sample"] == 8
    finally:
        rec.disarm()
    assert not METRICS.enabled and not TRACE.enabled
    assert TRACE.sample_n == 1 and METRICS.counted_dispatch
    assert not rec.armed


def test_recorder_sampler_thread_runs_and_stops():
    rec = FlightRecorder(interval_s=0.01)
    rec.arm()
    try:
        deadline = time.monotonic() + 5.0
        while rec.ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rec.ticks > 0
        assert rec.armed
    finally:
        rec.disarm()
    assert not rec.armed
    n = rec.ticks
    time.sleep(0.05)
    assert rec.ticks == n            # really stopped


def test_recorder_bounded_memory_and_probe_containment():
    rec = FlightRecorder(interval_s=3600.0, series_maxlen=8, max_series=4)
    calls = [0]
    rec.add_probe(lambda: calls.__setitem__(0, calls[0] + 1))

    def bad_probe():
        raise RuntimeError("probe boom")

    rec.add_probe(bad_probe)
    rec.arm()
    try:
        for i in range(20):
            METRICS.counter("a").inc()
            METRICS.counter("b").inc()
            METRICS.gauge("c").set(i)
            METRICS.gauge("d").set(i)
            METRICS.gauge(f"overflow.{i}").set(i)   # past max_series
            rec.tick(now=float(i))
        assert len(rec.series("counter.a")) == 8    # ring bounded
        assert len(rec.series_names()) == 4         # series cap held
        assert rec.snapshot()["dropped_series"] > 0
        assert calls[0] == 20                       # good probe ran each tick
        rec.remove_probe(bad_probe)                 # and never killed a tick
    finally:
        rec.disarm()


# -- SLO watchdog ------------------------------------------------------------

def _clocked_watchdog(specs, watchdog=SLOWatchdog):
    t = [0.0]

    def clock():
        return t[0]

    return watchdog(specs, clock=clock), t


def test_slo_level_breach_event_and_recovery():
    spec = SLOSpec("p99", ("metrics", "p99"), bound=100.0,
                   windows=(10.0, 40.0), budget=0.5)
    wd, t = _clocked_watchdog([spec])
    enable_observability()
    # healthy samples fill both windows
    for i in range(4):
        t[0] = float(i)
        st = wd.observe({"metrics": {"p99": 50.0}})
    assert st["p99"]["state"] == "ok"
    # sustained violation: the short window saturates fast, the long
    # window's burn crosses 1.0 (budget 0.5) once half its samples are bad
    for i in range(4, 10):
        t[0] = float(i)
        st = wd.observe({"metrics": {"p99": 500.0}})
    assert st["p99"]["state"] == "breach"
    assert st["p99"]["burn"]["10s"] >= 1.0
    assert wd.breaches["p99"] == 1
    breach_evs = [e for e in TRACE.events() if e["name"] == "slo.breach"]
    assert len(breach_evs) == 1 and breach_evs[0]["attrs"]["slo"] == "p99"
    # recovery: good samples age the bad ones out of the short window
    for i in range(10, 22):
        t[0] = float(i)
        st = wd.observe({"metrics": {"p99": 50.0}})
    assert st["p99"]["state"] == "ok"
    assert wd.breaches["p99"] == 1   # no double-count on recovery
    json.dumps(st)


def test_slo_rate_kind_counter_delta():
    spec = SLOSpec("shed", ("shed_queries",), bound=10.0, kind="rate",
                   windows=(5.0, 5.0), budget=0.5)
    wd, t = _clocked_watchdog([spec])
    total = 0
    for i in range(6):
        t[0] = float(i)
        total += 2                   # 2 sheds/s: under the 10/s bound
        st = wd.observe({"shed_queries": total})
    assert st["shed"]["state"] == "ok"
    assert st["shed"]["value"] == pytest.approx(2.0)
    for i in range(6, 12):
        t[0] = float(i)
        total += 100                 # 100/s: way over
        st = wd.observe({"shed_queries": total})
    assert st["shed"]["state"] == "breach"
    # a counter reset (service restart) clamps to 0, never negative
    t[0] = 12.0
    st = wd.observe({"shed_queries": 0})
    assert st["shed"]["value"] == 0.0


def test_slo_missing_field_and_breach_incident(tmp_path):
    wd, t = _clocked_watchdog([
        SLOSpec("x", ("absent", "path"), bound=1.0, windows=(1.0, 1.0))])
    st = wd.observe({"something": 1})     # absent path: no sample, no crash
    assert "value" not in st["x"] and st["x"]["state"] == "ok"
    # a breach writes an slo.<name> incident bundle when one is installed
    incident_mod.install(tmp_path / "inc")
    spec = SLOSpec("err", ("errs",), bound=1.0, windows=(5.0, 5.0),
                   budget=0.9)
    wd, t = _clocked_watchdog([spec])
    for i in range(5):
        t[0] = float(i)
        wd.observe({"errs": 100.0})
    bundles = incident_mod.manager().bundles()
    assert len(bundles) == 1 and bundles[0].name.endswith("slo-err")


def test_default_slos_cover_the_stock_objectives():
    names = {s.name for s in default_slos()}
    assert names == {"lookup_p99_ns", "fallback_rate", "error_rate",
                     "shed_rate", "merge_backlog_s", "wal_bytes"}
    with pytest.raises(ValueError, match="mode"):
        SLOSpec("bad", ("x",), 1.0, mode="avg")
    with pytest.raises(ValueError, match="budget"):
        SLOSpec("bad", ("x",), 1.0, budget=0.0)


def test_attach_slo_health_section_and_observe():
    keys = _keys(20_000)
    svc = PlexService(keys, 32, n_shards=2)
    try:
        enable_observability()
        # generous latency bound: a one-sample breach would make this test
        # machine-dependent
        wd = svc.attach_slo(SLOWatchdog(default_slos(lookup_p99_ns=1e12)))
        svc.lookup(keys[:svc.block].copy())
        st = wd.observe(svc.health())
        h = svc.health()
        assert set(h["slo"]) == set(st)
        assert all(v["state"] == "ok" for v in h["slo"].values())
        json.dumps(h)
        svc.attach_slo(None)
        assert "slo" not in svc.health()     # schema-additive: detachable
    finally:
        svc.close()


def test_merge_backlog_age_tracks_unmerged_threshold():
    from repro_torch.resilience.faults import POINT_MERGE_BUILD, fail_once
    keys = _keys(20_000)
    svc = PlexService(keys.copy(), 32, n_shards=2, merge_threshold=64,
                      merge_backoff_s=0.0)
    try:
        assert svc.health()["merge_backlog_s"] == 0.0
        with FAULTS.injected(POINT_MERGE_BUILD, fail_once()):
            # crosses the threshold; the auto-merge trips and is contained,
            # so the delta stays over-threshold and the backlog clock runs
            svc.insert(np.unique(np.arange(2**40, 2**40 + 128,
                                           dtype=np.uint64)))
        time.sleep(0.01)
        assert svc.health()["merge_backlog_s"] > 0.0
        assert svc.merge()           # fault cleared: explicit merge lands
        assert svc.health()["merge_backlog_s"] == 0.0
    finally:
        svc.close()


# -- incident bundles --------------------------------------------------------

def _read_bundle(bundle):
    out = {"incident": json.loads((bundle / "incident.json").read_text()),
           "health": json.loads((bundle / "health.json").read_text()),
           "metrics": json.loads((bundle / "metrics.json").read_text())}
    for line in (bundle / "spans.jsonl").read_text().splitlines():
        if line:
            json.loads(line)
    assert (bundle / "metrics.prom").exists()
    return out


def test_incident_bundle_contents_debounce_retention(tmp_path):
    t = [0.0]
    mgr = incident_mod.IncidentManager(
        tmp_path / "inc", debounce_s=10.0, retention=3,
        health_source=lambda: {"generation": 7, "degraded": True},
        clock=lambda: t[0])
    enable_observability()
    METRICS.counter("serve.lookups").inc(9)
    with TRACE.span("serve.lookup", n=4):
        pass
    b = mgr.trigger("breaker.open", "cuda breaker opened",
                    context={"breaker": "cuda"})
    assert b is not None and b.name == "0001-breaker-open"
    got = _read_bundle(b)
    assert got["incident"]["kind"] == "breaker.open"
    assert got["incident"]["context"]["breaker"] == "cuda"
    assert got["incident"]["generation"] == 7    # headline from health
    assert got["health"]["degraded"] is True
    assert got["metrics"]["registry"]["counters"]["serve.lookups"] == 9
    assert "armed_faults" in got["incident"]
    # debounce: same kind within the window is suppressed and counted
    t[0] = 5.0
    assert mgr.trigger("breaker.open", "again") is None
    assert mgr.debounced["breaker.open"] == 1
    # a different kind is fresh
    assert mgr.trigger("queue.shed", "overflow") is not None
    # past the window the kind fires again; retention keeps newest 3
    for i in range(3):
        t[0] = 20.0 + 20.0 * i
        assert mgr.trigger("breaker.open", f"flap {i}") is not None
    names = [p.name for p in mgr.bundles()]
    assert len(names) == 3
    assert names[-1].endswith("breaker-open")
    assert mgr.written == 5


def test_incident_seq_continues_across_install(tmp_path):
    root = tmp_path / "inc"
    incident_mod.install(root).trigger("queue.shed", "x")
    incident_mod.uninstall()
    mgr = incident_mod.install(root)      # fresh manager, same directory
    b = mgr.trigger("queue.shed", "y")
    assert b.name.startswith("0002-")     # sequence resumed, not reset


def test_report_noop_when_uninstalled_and_never_raises(tmp_path):
    incident_mod.report("breaker.open", "nobody listening")  # no-op
    mgr = incident_mod.install(tmp_path / "inc")

    def exploding_health():
        raise RuntimeError("health mid-failure")

    mgr.bind_health(exploding_health)
    incident_mod.report("merge.failure", "health source broken")
    got = _read_bundle(mgr.bundles()[0])
    assert "error" in got["health"]       # captured, not propagated


def test_breaker_open_writes_bundle(tmp_path):
    from repro_torch.resilience.breakers import CircuitBreaker
    incident_mod.install(tmp_path / "inc")
    br = CircuitBreaker("cuda", failure_threshold=2, cooldown_s=0.0)
    br.record_failure(RuntimeError("d1"))
    assert incident_mod.manager().bundles() == []   # below threshold
    br.record_failure(RuntimeError("d2"))           # -> open
    bundles = incident_mod.manager().bundles()
    assert len(bundles) == 1
    got = _read_bundle(bundles[0])
    assert got["incident"]["kind"] == "breaker.open"
    assert got["incident"]["context"]["breaker"] == "cuda"


def test_chain_exhaustion_and_shed_bundles(tmp_path):
    from repro_torch.resilience import BackendUnavailableError, \
        QueueFullError
    from repro_torch.resilience.faults import POINT_BACKEND_DISPATCH, always
    keys = _keys(20_000)
    svc = PlexService(keys.copy(), 32, n_shards=2, backend="torch",
                      fallback=None, breaker_threshold=100,
                      max_queue=64, overflow="shed", max_delay_s=60.0)
    incident_mod.install(tmp_path / "inc", health_source=svc.health)
    try:
        with FAULTS.injected(POINT_BACKEND_DISPATCH,
                             always(backend="torch")):
            with pytest.raises(BackendUnavailableError):
                svc.lookup(keys[:100].copy())
        t1 = svc.submit(keys[:60].copy())     # parked sub-block (60 queued)
        t2 = svc.submit(keys[:10].copy())     # 70 > 64: shed
        kinds = [json.loads((b / "incident.json").read_text())["kind"]
                 for b in incident_mod.manager().bundles()]
        assert kinds == ["backend.unavailable", "queue.shed"]
        for b in incident_mod.manager().bundles():
            got = _read_bundle(b)
            # health captured through the service source at trigger time
            assert "generation" in got["health"]
        svc.drain()
        np.testing.assert_array_equal(t1.result(),
                                      np.searchsorted(keys, keys[:60]))
        with pytest.raises(QueueFullError):
            t2.result()
    finally:
        svc.close()


def test_quarantine_and_manifest_bundles(tmp_path):
    from repro_torch.persist.manifest import (CorruptManifestError,
                                              Manifest, gen_name,
                                              read_manifest, write_manifest)
    incident_mod.install(tmp_path / "inc", debounce_s=0.0)
    # corrupt manifest read
    root = tmp_path / "dur"
    root.mkdir()
    write_manifest(root, Manifest.for_generation(0))
    (root / "MANIFEST.json").write_text("{ torn")
    with pytest.raises(CorruptManifestError):
        read_manifest(root)
    kinds = [json.loads((b / "incident.json").read_text())["kind"]
             for b in incident_mod.manager().bundles()]
    assert kinds == ["manifest.corrupt"]
    # LKG quarantine during open(): destroy the newest generation's
    # snapshot so recovery falls back to gen 0 and quarantines gen 1
    droot = tmp_path / "svc"
    droot.mkdir()
    keys = _keys(20_000)
    svc = PlexService(keys.copy(), 32, n_shards=2,
                      keep_generations=2, merge_threshold=0)
    try:
        svc.save(droot, fsync=False)
        svc.insert(np.unique(np.arange(2**40, 2**40 + 64,
                                       dtype=np.uint64)))
        assert svc.merge() and svc.generation == 1
    finally:
        svc.close()
    (droot / gen_name(1) / "snapshot.plex").write_bytes(b"garbage")
    svc2 = _PortService.open(droot, fsync=False, device="cpu")
    try:
        assert svc2.generation == 0
        kinds = [json.loads((b / "incident.json").read_text())["kind"]
                 for b in incident_mod.manager().bundles()]
        assert "generation.quarantine" in kinds
    finally:
        svc2.close()


# -- the port's own: no device read in a span, the drill, imports ------------

def test_tensor_attribute_is_described_not_read(monkeypatch):
    """A span attribute that is a tensor is exported without ``.item()``
    or a value-printing ``repr`` (on a CUDA tensor either waits for the
    card): its shape, dtype and device only."""
    def boom(*a, **k):
        raise AssertionError("a span read a tensor's value")

    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.Tensor, "__repr__", boom)
    monkeypatch.setattr(torch.Tensor, "tolist", boom)
    enable_observability()
    x = torch.arange(5, dtype=torch.int64)
    with TRACE.span("serve.dispatch", n=x, scalar=torch.tensor(3)):
        pass
    TRACE.record("serve.sync", 1e-6, planes=x)
    TRACE.event("marker", plane=x)
    evs = TRACE.events()
    assert [e["name"] for e in evs] == ["serve.dispatch", "serve.sync",
                                        "marker"]
    assert evs[0]["attrs"]["n"] == \
        "tensor(shape=[5], dtype=torch.int64, device=cpu)"
    assert evs[0]["attrs"]["scalar"].startswith("tensor(shape=[]")
    for line in TRACE.to_jsonl().splitlines():
        json.loads(line)


def test_observe_drill_runs_on_the_cpu(tmp_path):
    from repro_torch.launch import observe
    # one intra-op thread: on a host shared with other test workers a
    # multi-threaded op waits for its slowest thread, and the recorder's
    # budget is a timing
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = observe.main(["--device", "cpu", "--n", "20000", "--queries",
                            "8000", "--dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    assert out["hook_frac"] < observe.OVERHEAD_BUDGET
    assert out["recorder_ratio"] < 1 + observe.RECORDER_OVERHEAD_BUDGET
    assert out["tick_frac"] < observe.TICK_DUTY_BUDGET
    assert len(out["span_names"]) >= 6
    lines = pathlib.Path(out["jsonl"]).read_text().splitlines()
    assert json.loads(lines[-1])["type"] == "metrics"
    assert len(lines) - 1 == out["spans"] > 0
    _parse_prometheus(pathlib.Path(out["prom"]).read_text())
    assert "metrics" in json.loads(pathlib.Path(out["health"]).read_text())
    assert not observability_enabled() and not RECORDER.armed


NEW_MODULES = ("obs/__init__.py", "obs/trace.py", "obs/export.py",
               "obs/recorder.py", "obs/incident.py", "obs/slo.py",
               "core/parallel_build.py", "launch/observe.py",
               "distrib/__init__.py", "distrib/placement.py",
               "distrib/partition.py", "distrib/routed_lookup.py",
               "distrib/loader.py")


def _imported_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_the_reference(rel):
    names = _imported_names(ROOT / "src" / "repro_torch" / rel)
    bad = {n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_port_import_pulls_in_no_jax():
    """Importing the port's observability, parallel build and drill (and
    the service they hook) loads neither jax nor the reference package."""
    code = ("import sys\n"
            "import repro_torch.obs, repro_torch.core.parallel_build\n"
            "import repro_torch.launch.observe, repro_torch.serving\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


# -- parity with the reference -----------------------------------------------

def _drive_registry(reg):
    reg.counter("wal.append_records").inc(3)
    reg.counter("serve.dispatch.cuda").inc(11)
    reg.gauge("queue.depth").set(7.25)
    for v in (0.5, 3.0, 30.0, 300.0, 3e6, 17.0, 1e10, 2e10):
        reg.histogram("serve.lookup_us").observe(v)
    reg.histogram("serve.queue_wait_us").observe(12.5)
    reg.vector("serve.shard.routed", 3).add(np.asarray([1, 2, 3]))
    reg.vector("serve.probe.trips", 14).add_at(5, 9)


def test_prometheus_text_parity():
    from repro.obs.metrics import MetricsRegistry as RRegistry
    a, b = MetricsRegistry(), RRegistry()
    _drive_registry(a)
    _drive_registry(b)
    assert prometheus_text(a) == r_prometheus_text(b)
    assert prometheus_text(a, prefix="x") == \
        r_prometheus_text(b, prefix="x")
    assert json.dumps(a.snapshot(), sort_keys=True) == \
        json.dumps(b.snapshot(), sort_keys=True)


# the port's backend names against the reference's
_NAMES = {"torch": "jnp", "cuda": "pallas", "numpy": "numpy"}


# the port's spans inside a served request, which the reference has not
_PORT_ONLY = {"serve.new_state", "serve.lock", "serve.take", "serve.timer",
              "serve.drain.wait", "serve.copy_back", "serve.cache_count",
              "serve.fill", "serve.deadline_flush"}


def _port_only(e) -> bool:
    """A span the reference does not record: a name of ``_PORT_ONLY``, or
    a queue block's staging and dispatch (they carry the block's
    ``reqs``)."""
    return e["name"] in _PORT_ONLY or "reqs" in e.get("attrs", {})


def _trace_seq(events, port=False):
    """(name, non-timing attrs, depth) of each event, incident events and
    their tmp paths left out. ``port``: the port's events seen as the
    reference records them: its backend names translated, the request
    spans it alone has left out, request ids dropped, and each depth
    counted over the ancestors that are kept (through the ``parent``
    ids)."""
    by_id = {e["id"]: e for e in events} if port else {}
    out = []
    for e in events:
        if e["name"] == "incident.bundle" or (port and _port_only(e)):
            continue
        attrs = dict(e.get("attrs", {}))
        depth = e["depth"]
        if port:
            for k in ("backend", "breaker"):
                if k in attrs:
                    attrs[k] = _NAMES[attrs[k]]
            attrs.pop("req", None)
            depth, parent = 0, e["parent"]
            while parent is not None:
                anc = by_id[parent]
                depth += not _port_only(anc)
                parent = anc["parent"]
        out.append((e["name"], attrs, depth))
    return out


def _bundles(root):
    return [(p.name, sorted(f.name for f in p.iterdir()),
             json.loads((p / "incident.json").read_text())["kind"])
            for p in sorted(root.iterdir())]


def _parity_keys(n=20_000, seed=11):
    # below 2^53: the packages' splines agree there (R1)
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 2**53, n, dtype=np.uint64))


def _drive_service(svc, keys, fresh):
    rng = np.random.default_rng(3)
    q = keys[rng.integers(0, keys.size, 3000)]
    out = [svc.lookup(q)]
    t = svc.submit(q[:700])
    svc.drain()
    out.append(t.result())
    svc.insert(fresh[:200])
    svc.delete(keys[:50])
    out.append(svc.lookup(q[:1000]))
    svc.insert(fresh[200:])                 # crosses the threshold: merge
    model = svc.logical_keys()
    out.append(svc.lookup(model[::97]))
    return out


def test_service_span_sequence_parity():
    """The same keys, lookups, submit/drain, inserts, deletes and a merge
    on both services emit the same span sequence: names, non-timing
    attributes and nesting, event for event. The queue's deadline is far
    beyond the test, so ``drain()`` flushes the remainder on both services
    (a deadline timer firing first on one of them would add its flush's
    spans and change ``serve.drain``'s ``queued``)."""
    keys = _parity_keys()
    fresh = np.unique(np.random.default_rng(4).integers(
        0, 2**53, 400, dtype=np.uint64))
    kw = dict(n_shards=2, block=512, merge_threshold=300, max_delay_s=60.0)
    enable_observability()
    R.enable_observability()
    port = PlexService(keys.copy(), 32, backend="torch", **kw)
    ref = RService(keys.copy(), 32, backend="jnp", **kw)
    try:
        got = _drive_service(port, keys, fresh)
        want = _drive_service(ref, keys, fresh)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert port.stats.merges == ref.stats.merges == 1
        a = _trace_seq(TRACE.events(), port=True)
        b = _trace_seq(R.TRACE.events())
        assert len(a) == len(b) > 20
        assert a == b
    finally:
        port.close()
        ref.close()


def test_incident_parity_under_injected_faults(tmp_path):
    """Under the same injected faults both services write the same
    incident kinds, bundle directory names and bundle files, and trace the
    same breaker transitions."""
    from repro_torch.resilience import always, fail_once
    from repro_torch.resilience.faults import (POINT_BACKEND_DISPATCH,
                                               POINT_MERGE_BUILD)
    from repro.resilience.faults import POINT_BACKEND_DISPATCH as RP_DISP
    from repro.resilience.faults import POINT_MERGE_BUILD as RP_MERGE
    keys = _parity_keys(12_000)
    kw = dict(n_shards=2, block=512, fallback=None, breaker_threshold=1,
              breaker_cooldown_s=3600.0, max_queue=64, overflow="shed",
              max_delay_s=60.0, merge_threshold=0)

    def scenario(svc, inc, faults, disp, merge_pt, always_, fail_once_,
                 backend, root):
        inc.install(root)
        with faults.injected(disp, always_(backend=backend)):
            with pytest.raises(Exception):
                svc.lookup(keys[:100].copy())
        t1 = svc.submit(keys[:60].copy())
        t2 = svc.submit(keys[:10].copy())         # 70 > 64: shed
        svc.insert(np.arange(2**40, 2**40 + 32, dtype=np.uint64))
        with faults.injected(merge_pt, fail_once_()):
            with pytest.raises(Exception):
                svc.merge()
        inc.uninstall()
        return t1, t2

    enable_observability()
    R.enable_observability()
    port = PlexService(keys.copy(), 32, backend="torch", **kw)
    ref = RService(keys.copy(), 32, backend="jnp", **kw)
    try:
        scenario(port, incident_mod, FAULTS, POINT_BACKEND_DISPATCH,
                 POINT_MERGE_BUILD, always, fail_once, "torch",
                 tmp_path / "port")
        scenario(ref, r_incident_mod, RFAULTS, RP_DISP, RP_MERGE, r_always,
                 r_fail_once, "jnp", tmp_path / "ref")
        a, b = _bundles(tmp_path / "port"), _bundles(tmp_path / "ref")
        assert [k for *_, k in a] == ["breaker.open", "backend.unavailable",
                                      "queue.shed", "merge.failure"]
        assert a == b
        pa = [e["attrs"]["kind"] for e in TRACE.events()
              if e["name"] == "incident.bundle"]
        pb = [e["attrs"]["kind"] for e in R.TRACE.events()
              if e["name"] == "incident.bundle"]
        assert pa == pb == [k for *_, k in a]
        tr = [e for e in _trace_seq(TRACE.events(), port=True)
              if e[0] == "breaker.transition"]
        assert tr == [e for e in _trace_seq(R.TRACE.events())
                      if e[0] == "breaker.transition"]
        assert tr and tr[0][1]["to"] == "open"
    finally:
        port.close()
        ref.close()


def _health_samples():
    """A health sequence that breaches, recovers and resets counters."""
    out = []
    shed = fall = 0
    for i in range(40):
        shed += 0 if i < 10 else 50 if i < 25 else 1
        fall += 3 if 15 <= i < 30 else 0
        if i == 32:
            shed = fall = 0                    # a restart
        out.append({
            "metrics": {"registry": {"histograms": {
                "serve.lookup_ns_per_key": {
                    "p99": 40_000.0 if i < 12 or i > 28 else 90_000.0}}}},
            "fallback_lookups": fall, "backend_failures": i // 7,
            "shed_queries": shed, "merge_backlog_s": 0.0 if i % 9 else 80.0,
            "wal_bytes": 1000 * i})
    return out


def test_slo_watchdog_status_parity():
    windows = (5.0, 20.0)
    extra = dict(budget=0.3, windows=windows)
    a, ta = _clocked_watchdog(
        list(default_slos(windows=windows))
        + [SLOSpec("min_keys", ("wal_bytes",), 5000.0, mode="min",
                   **extra)])
    b, tb = _clocked_watchdog(
        list(r_default_slos(windows=windows))
        + [RSLOSpec("min_keys", ("wal_bytes",), 5000.0, mode="min",
                    **extra)], watchdog=RSLOWatchdog)
    enable_observability()
    R.enable_observability()
    states = set()
    for i, h in enumerate(_health_samples()):
        ta[0] = tb[0] = 1.5 * i
        sa, sb = a.observe(h), b.observe(h)
        assert sa == sb, i
        assert a.status() == b.status()
        states |= {v["state"] for v in sa.values()}
    assert states == {"ok", "breach"}
    assert a.breaches == b.breaches and sum(a.breaches.values()) > 0
    assert _trace_seq(TRACE.events(), port=True) == \
        _trace_seq(R.TRACE.events())
