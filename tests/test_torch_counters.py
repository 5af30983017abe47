"""K1's counted dispatch in the port, held against the reference's.

``probe_bucket`` against ``jnp_lookup._probe_bucket`` over every travel from
-2^10 to 2^20; the counter plane of the plain version against the
reference's ``_stacked_counted`` over {radix, CHT} x {probe count, bisect}
x {no delta, live delta}, with results identical to uncounted ones; the
service's ``live_hotness()`` against ``np.bincount(route(q))`` on the fused
and per-shard paths, through merged and queued lookups and across a merge,
and its probe histogram against the reference service's (the scenarios of
``tests/test_obs.py`` without the mesh); one launch per micro-batch with
the cache or the counters on; the port's metrics registry.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import generate
from repro.kernels import jnp_lookup as RJ
from repro.kernels import planes as RP
from repro.kernels.pairs import split_u64
from repro.obs.metrics import METRICS as RMETRICS
from repro.serving import PlexService as RService
from repro_torch.kernels import planes as TP
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.keys import to_biased
from repro_torch.obs.metrics import METRICS, RING_SIZE, Histogram, \
    MetricsRegistry
from repro_torch.serving import PlexService

from test_torch_planes import _port_plex
from test_torch_stacked_lookup import _delta, _forced, _queries, _wrapped, \
    keys, offs  # noqa: F401  (module fixtures)


@pytest.fixture(autouse=True)
def _reset_registries():
    yield
    for m in (METRICS, RMETRICS):
        m.reset()
        m.disable()
        m.counted_dispatch = True


def _tq(q: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(to_biased(np.asarray(q, np.uint64)))


def _keys(n: int = 50_000, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 2**62, n, dtype=np.uint64))


def test_probe_bucket_matches_reference_over_its_range():
    travel = np.arange(-(1 << 10), (1 << 20) + 1, dtype=np.int32)
    want = np.asarray(RJ._probe_bucket(jnp.asarray(travel)))
    got = SL.probe_bucket(torch.from_numpy(travel.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)
    assert got[travel == 8192].item() == 13       # R7: log(x) / log(2)
    assert got.max().item() == SL.N_PROBE_BUCKETS - 1 == RJ.N_PROBE_BUCKETS - 1


@pytest.mark.parametrize("fold", [False, True], ids=["cap0", "delta"])
@pytest.mark.parametrize("probe", ["count", "bisect"])
@pytest.mark.parametrize("kind", ["radix", "cht"])
def test_counter_plane_matches_reference(kind, probe, fold, keys, offs):
    """Counted micro-batches of 1,024: the ranks equal the uncounted
    plain version's, and the accumulated counter plane (per-shard routed
    counts, then the probe histogram) equals the reference's. Keys whose
    radix prefix the reference wraps (R5) probe elsewhere there and are
    left out."""
    rng = np.random.default_rng(21)
    pxs = _forced(keys, offs, kind)
    sp = RP.build_stacked_planes(pxs, offs)
    tsp = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    rdp = tdp = None
    extra = ()
    if fold:
        rdp, tdp, extra, _ = _delta(keys, rng)
    q = _queries(keys, offs, rng, extra)
    q = q[~_wrapped(tsp, q)]
    n_shards = tsp.n_shards
    counters = torch.zeros(n_shards + SL.N_PROBE_BUCKETS, dtype=torch.int64)
    fn = jax.jit(functools.partial(
        RJ._stacked_counted,
        functools.partial(RJ._stacked_pipeline_aux, sp, probe), n_shards,
        0 if rdp is None else rdp.cap))
    delta = () if rdp is None else (rdp.khi, rdp.klo, rdp.cum0)
    rcounters = jnp.zeros(n_shards + RJ.N_PROBE_BUCKETS, jnp.uint32)
    for i in range(0, q.size, 1024):
        qb = q[i:i + 1024]
        got = SL.stacked_lookup(tsp, probe, _tq(qb), tdp,
                                counters=counters)[0]
        plain = SL.stacked_lookup(tsp, probe, _tq(qb), tdp)[0]
        assert torch.equal(got, plain)
        qh, ql = split_u64(qb)
        _, rcounters = fn(jnp.asarray(qh), jnp.asarray(ql),
                          np.int32(qb.size), rcounters, *delta)
    want = np.asarray(rcounters).astype(np.int64)
    assert np.array_equal(counters.numpy(), want)
    assert counters[:n_shards].sum() == counters[n_shards:].sum() == q.size


# (dataset, keys, shards): fused, and per-shard (mixed radix/CHT shards)
PATHS = {"fused": ("amzn", 40_000, 4), "per_shard": ("face", 100_000, 2)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_counted_dispatch_bit_identical(path):
    """Arming METRICS never changes a result, on either path."""
    name, n, shards = PATHS[path]
    fused = path == "fused"
    keys = generate(name, n, 0)
    svc = PlexService(keys.copy(), 32, n_shards=shards, block=512,
                      cache_slots=1 << 12, device="cpu")
    assert svc.fused is fused
    q = np.random.default_rng(0).choice(keys, 4000)
    off = svc.lookup(q)
    METRICS.enable()
    on = svc.lookup(q)
    assert np.array_equal(off, on)
    assert np.array_equal(on, np.searchsorted(keys, q, "left"))
    assert svc.live_hotness().sum() == q.size


@pytest.mark.parametrize("path", sorted(PATHS))
def test_live_hotness_is_exact_bincount(path):
    name, n, shards = PATHS[path]
    fused = path == "fused"
    keys = generate(name, n, 0)
    svc = PlexService(keys.copy(), 32, n_shards=shards, block=512,
                      device="cpu")
    assert svc.fused is fused
    assert svc.live_hotness().tolist() == [0] * shards
    rng = np.random.default_rng(1)
    METRICS.enable()
    q1 = rng.choice(keys, 6000)
    q2 = rng.choice(keys, 3000)
    svc.lookup(q1)
    svc.lookup(q2)
    want = (np.bincount(svc.route(q1), minlength=shards)
            + np.bincount(svc.route(q2), minlength=shards))
    assert np.array_equal(svc.live_hotness(), want)
    # every counted query lands in one probe bucket; the per-shard path
    # routes on the host and probes nothing it counts
    assert svc.probe_trip_hist().sum() == (9000 if fused else 0)
    assert METRICS.vector("serve.shard.routed", shards).snapshot() == \
        want.tolist()
    assert METRICS.counter("serve.routed_queries").snapshot() == 9000


def test_hotness_counts_merged_and_queued_lookups():
    keys = _keys(40_000)
    svc = PlexService(keys, 32, n_shards=4, block=512, merge_threshold=0,
                      device="cpu")
    assert svc.fused
    fresh = np.unique(np.random.default_rng(2).integers(
        0, 2**62, 500, dtype=np.uint64))
    svc.insert(fresh)                    # a live delta: merged launches
    model = svc.logical_keys()
    rng = np.random.default_rng(3)
    q = model[rng.integers(0, model.size, 5000)]
    METRICS.enable()
    assert np.array_equal(svc.lookup(q), np.searchsorted(model, q, "left"))
    t = svc.submit(q[:2000])             # the queue counts too
    svc.drain()
    assert np.array_equal(t.result(),
                          np.searchsorted(model, q[:2000], "left"))
    want = (np.bincount(svc.route(q), minlength=4)
            + np.bincount(svc.route(q[:2000]), minlength=4))
    assert np.array_equal(svc.live_hotness(), want)
    assert svc.probe_trip_hist().sum() == 7000


def test_hotness_resets_at_merge_epoch():
    keys = _keys(40_000)
    svc = PlexService(keys, 32, n_shards=4, block=512, merge_threshold=256,
                      device="cpu")
    METRICS.enable()
    rng = np.random.default_rng(4)
    svc.lookup(rng.choice(keys, 3000))
    assert svc.live_hotness().sum() == 3000
    svc.insert(np.unique(rng.integers(0, 2**62, 600, dtype=np.uint64)))
    assert svc.stats.merges == 1
    assert svc.live_hotness().sum() == 0
    assert svc.probe_trip_hist().sum() == 0
    model = svc.logical_keys()
    q = model[rng.integers(0, model.size, 2000)]
    svc.lookup(q)
    assert np.array_equal(svc.live_hotness(),
                          np.bincount(svc.route(q), minlength=4))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_counts_of_a_replaced_state_are_dropped(path):
    """A counted lookup that captured its state before a publish (same
    shard count) folds nothing into the new epoch's hotness."""
    name, n, shards = PATHS[path]
    keys = generate(name, n, 0)
    svc = PlexService(keys.copy(), 32, n_shards=shards, block=512,
                      merge_threshold=0, device="cpu")
    assert svc.fused is (path == "fused")
    rng = np.random.default_rng(6)
    old = svc._state
    svc.insert(rng.choice(keys, 600))
    assert svc.merge() and svc.n_shards == shards
    METRICS.enable()
    q = rng.choice(keys, 3000)
    svc._lookup(old, q)
    assert svc.live_hotness().sum() == 0
    assert svc.probe_trip_hist().sum() == 0
    svc.lookup(q)
    assert svc.live_hotness().sum() == 3000


@pytest.mark.parametrize("shards", [1, 4])
def test_probe_histogram_matches_reference_service(shards):
    """The same counted traffic through the port and the reference
    (``backend="jnp"``): equal live hotness and probe histograms, delta-free
    and with a live delta."""
    keys = _keys(40_000, seed=6)
    kw = dict(n_shards=shards, block=512, merge_threshold=0)
    port = PlexService(keys.copy(), 32, device="cpu", **kw)
    ref = RService(keys.copy(), 32, backend="jnp", **kw)
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.choice(keys, 3000),
                        rng.integers(0, 2**62, 1000, dtype=np.uint64)])
    METRICS.enable()
    RMETRICS.enable()
    for svc in (port, ref):
        svc.lookup(q)
    ins = rng.integers(0, 2**62, 300, dtype=np.uint64)
    for svc in (port, ref):
        svc.insert(ins)
        svc.delete(keys[:40])
        svc.lookup(q)
    assert np.array_equal(port.live_hotness(), ref.live_hotness())
    assert np.array_equal(port.probe_trip_hist(), ref.probe_trip_hist())
    assert port.probe_trip_hist().sum() == 2 * q.size
    assert METRICS.vector("serve.probe.trips", SL.N_PROBE_BUCKETS) \
        .snapshot() == port.probe_trip_hist().tolist()


def test_one_launch_per_microbatch_with_cache_and_counters(monkeypatch):
    """Every micro-batch is one call of the K1 wrapper, cached or counted,
    delta-free or merged (the ``test_single_pallas_call_per_dispatch``
    invariant)."""
    keys = generate("amzn", 30_000, 0)
    svc = PlexService(keys.copy(), 16, n_shards=3, block=512,
                      cache_slots=1 << 12, merge_threshold=0, device="cpu")
    calls = []
    orig = SL.stacked_lookup

    def record(*a, **kw):
        calls.append(("cache" if kw.get("cache") is not None else
                      "counters" if kw.get("counters") is not None
                      else "plain"))
        return orig(*a, **kw)
    monkeypatch.setattr(SL, "stacked_lookup", record)
    q = keys[np.random.default_rng(1).integers(0, keys.size, 1_300)]
    for armed in (False, True):
        METRICS.enabled = armed
        for update in (False, True):
            if update:
                svc.insert(q[:5] + np.uint64(1))
            calls.clear()
            b0 = svc.stats.batches
            svc.lookup(q)
            assert len(calls) == svc.stats.batches - b0 == 3
            assert set(calls) == {"counters" if armed else "cache"}


# --------------------------------------------------------- the registry ----

def test_registry_counters_gauges_vectors():
    r = MetricsRegistry()
    c = r.counter("a.b")
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    assert r.counter("a.b") is c
    r.gauge("g").set(2.5)
    v = r.vector("shards", 4)
    v.add(np.asarray([1, 2, 3, 4]))
    v.add_at(0, 10)
    assert v.snapshot() == [11, 2, 3, 4]
    with pytest.raises(ValueError, match="shape"):
        v.add(np.zeros(3))
    v2 = r.vector("shards", 6)
    assert v2 is not v and v2.snapshot() == [0] * 6
    snap = r.snapshot()
    assert snap["counters"]["a.b"] == 5
    assert snap["gauges"]["g"] == 2.5
    json.dumps(snap)


def test_histogram_percentiles_and_ring_wrap():
    h = Histogram("lat")
    for v in range(1, 1001):
        h.observe(float(v))
    assert h.count == 1000 and h.max == 1000.0
    assert h.percentile(0.50) == 500.0
    assert h.percentile(0.99) == 990.0
    assert h.percentile(0.0) == 1.0
    for _ in range(RING_SIZE):
        h.observe(10_000.0)
    assert h.percentile(0.50) == 10_000.0
    assert h.count == 1000 + RING_SIZE
    buckets = h.bucket_counts()
    assert buckets[-1] == (float("inf"), h.count)
    assert set(h.snapshot()) == {"count", "sum", "max", "p50", "p90", "p99"}


def test_port_registry_is_separate_from_the_reference():
    assert METRICS is not RMETRICS
    METRICS.enable()
    METRICS.counter("x").inc()
    assert not RMETRICS.enabled
    assert "x" not in RMETRICS.snapshot()["counters"]
