"""Fault-tolerant serving in the port: the chaos matrix of
``tests/test_resilience.py`` (the tests that need no mesh), with the same
seeded inputs through the reference where the two can be held together.

Every injection point x scenario must end in one of exactly two outcomes —
**parity** (the answer equals ``np.searchsorted`` over the logical key
array, possibly served degraded through the fallback chain
``cuda`` -> ``torch`` -> ``numpy``) or a **typed fast failure**. Never a
wrong answer, never a hang, and the last-known-good generation always
opens. Port entry points run with ``device="cpu"``, where the ``cuda``
backend is K1's plain version; the reference serves through ``jnp``.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.resilience import FAULTS as RFAULTS
from repro.resilience import CircuitBreaker as RBreaker
from repro.resilience import FaultRegistry as RRegistry
from repro.resilience import InjectedFault as RInjected
from repro.resilience import always as r_always
from repro.resilience import fail_n as r_fail_n
from repro.resilience import fail_once as r_fail_once
from repro.resilience import intermittent as r_intermittent
from repro.serving import PlexService as RService
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.persist import gen_name, read_manifest, wal_name
from repro_torch.resilience import (CLOSED, HALF_OPEN, OPEN, FAULTS,
                                    INJECTION_POINTS, BackendUnavailableError,
                                    CircuitBreaker, FaultRegistry,
                                    InjectedFault, MergeFailedError,
                                    NoServableGenerationError, QueueFullError,
                                    always, fail_n, fail_once, intermittent)
from repro_torch.resilience.faults import (POINT_BACKEND_DISPATCH,
                                           POINT_BACKEND_FACTORY,
                                           POINT_MANIFEST_COMMIT,
                                           POINT_MERGE_BUILD,
                                           POINT_MERGE_WORKER,
                                           POINT_SNAPSHOT_MAP,
                                           POINT_WAL_APPEND, POINT_WAL_FSYNC)
from repro_torch.serving import PlexService
from repro_torch.serving.plex_service import QUARANTINE_DIR, \
    default_fallback

from conftest import sorted_u64

BLOCK = 512


@pytest.fixture(autouse=True)
def _clean_faults():
    """No armed scenario may leak between tests (either package's)."""
    FAULTS.reset()
    RFAULTS.reset()
    yield
    FAULTS.reset()
    RFAULTS.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _service(rng, n=20_000, **kw):
    keys = sorted_u64(rng, n)
    kw.setdefault("eps", 32)
    kw.setdefault("n_shards", 2)
    kw.setdefault("block", BLOCK)
    kw.setdefault("device", "cpu")
    return PlexService(keys.copy(), **kw), keys


def _queries(rng, keys, n_present=2_000, n_absent=200):
    q = np.concatenate([keys[rng.integers(0, keys.size, n_present)],
                        rng.integers(0, 1 << 62, n_absent, dtype=np.uint64)])
    return q, np.searchsorted(keys, q, side="left")


# ---------------------------------------------------------- fault registry ----

def test_point_names_are_the_references():
    from repro.resilience import INJECTION_POINTS as R_POINTS
    assert INJECTION_POINTS == R_POINTS


def test_registry_scenarios_deterministic():
    reg = FaultRegistry()
    reg.inject("p", fail_n(2))
    for i in range(4):
        if i < 2:
            with pytest.raises(InjectedFault):
                reg.fire("p")
        else:
            reg.fire("p")
    assert reg.trips("p") == 2
    assert reg.active() == {}


def test_registry_context_match_and_cleanup():
    reg = FaultRegistry()
    with reg.injected("p", fail_once(backend="cuda")):
        reg.fire("p", backend="numpy")          # no match, passes
        with pytest.raises(InjectedFault):
            reg.fire("p", backend="cuda")
    reg.fire("p", backend="cuda")                # disarmed on exit
    assert reg.trips("p") == 1
    assert reg.snapshot() == {"active": {}, "trips": {"p": 1}}


def test_registry_intermittent_is_seeded():
    """The same seed trips the same calls in both packages."""
    def trips(registry, scenario, exc, seed):
        reg = registry()
        reg.inject("p", scenario(0.5, seed))
        pattern = []
        for _ in range(64):
            try:
                reg.fire("p")
                pattern.append(0)
            except exc:
                pattern.append(1)
        return pattern

    a = trips(FaultRegistry, intermittent, InjectedFault, 7)
    assert a == trips(FaultRegistry, intermittent, InjectedFault, 7)
    assert a == trips(RRegistry, r_intermittent, RInjected, 7)
    assert 0 < sum(a) < 64
    assert trips(FaultRegistry, intermittent, InjectedFault, 8) != a
    with pytest.raises(ValueError):
        intermittent(1.5, 0)


def test_registry_custom_exception_type():
    reg = FaultRegistry()
    reg.inject("p", fail_once(exc=OSError))
    with pytest.raises(OSError):
        reg.fire("p")


# --------------------------------------------------------- circuit breaker ----

def test_breaker_lifecycle_with_injectable_clock():
    """The port's breaker walks the reference's through the same calls,
    snapshot for snapshot."""
    clocks = FakeClock(), FakeClock()
    brs = [cls("b", failure_threshold=2, cooldown_s=10.0, clock=clk)
           for cls, clk in zip((CircuitBreaker, RBreaker), clocks)]

    def both(fn):
        outs = [fn(br) for br in brs]
        assert outs[0] == outs[1]
        assert brs[0].snapshot() == brs[1].snapshot()
        return outs[0]

    def advance(dt):
        for c in clocks:
            c.advance(dt)

    assert both(lambda b: (b.state, b.allow())) == (CLOSED, True)
    both(lambda b: b.record_failure(RuntimeError("x")))
    assert both(lambda b: b.state) == CLOSED
    both(lambda b: b.record_failure(RuntimeError("y")))
    assert both(lambda b: b.state) == OPEN
    assert not both(lambda b: b.allow())
    advance(9.0)
    assert not both(lambda b: b.allow())
    advance(2.0)
    assert both(lambda b: b.state) == HALF_OPEN
    assert both(lambda b: b.allow())
    assert not both(lambda b: b.allow())       # one probe at a time
    both(lambda b: b.record_failure(RuntimeError("z")))
    assert both(lambda b: (b.state, b.allow())) == (OPEN, False)
    advance(11.0)
    assert both(lambda b: b.allow())
    both(lambda b: b.record_success())
    assert both(lambda b: (b.state, b.allow())) == (CLOSED, True)
    snap = brs[0].snapshot()
    assert snap["state"] == CLOSED and snap["opens"] == 2
    json.dumps(snap)


def test_breaker_success_resets_consecutive_count():
    br = CircuitBreaker("b", failure_threshold=3)
    br.record_failure(RuntimeError())
    br.record_failure(RuntimeError())
    br.record_success()
    br.record_failure(RuntimeError())
    br.record_failure(RuntimeError())
    assert br.state == CLOSED
    with pytest.raises(ValueError):
        CircuitBreaker("b", failure_threshold=0)


# ------------------------------------------------- fallback chain (lookup) ----

SCENARIOS = {
    # name: (the port's scenario, the reference's), by backend
    "fail_once": (lambda b: fail_once(backend=b),
                  lambda b: r_fail_once(backend=b)),
    "fail_n": (lambda b: fail_n(3, backend=b),
               lambda b: r_fail_n(3, backend=b)),
    "always": (lambda b: always(backend=b), lambda b: r_always(backend=b)),
    "intermittent": (lambda b: intermittent(0.5, 11, backend=b),
                     lambda b: r_intermittent(0.5, 11, backend=b)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dispatch_fault_matrix_parity(rng, scenario):
    """Every dispatch scenario on the default backend, the same one armed
    on the reference's: exact searchsorted parity and the reference's
    ranks, served through the chain (degraded or primary), never wrong."""
    port_scen, ref_scen = SCENARIOS[scenario]
    svc, keys = _service(rng)
    ref = RService(keys.copy(), eps=32, n_shards=2, block=BLOCK,
                   backend="jnp")
    q, exp = _queries(rng, keys)
    with FAULTS.injected(POINT_BACKEND_DISPATCH, port_scen("cuda")), \
            RFAULTS.injected(POINT_BACKEND_DISPATCH, ref_scen("jnp")):
        for _ in range(3):
            got = svc.lookup(q)
            assert np.array_equal(got, exp)
            assert np.array_equal(got, ref.lookup(q))
    assert FAULTS.trips(POINT_BACKEND_DISPATCH) > 0
    assert svc.stats.fallback_lookups > 0
    assert np.array_equal(svc.lookup(q), exp)    # clean again once disarmed


def test_fallback_counts_and_breaker_opens_then_recovers(rng):
    clk = FakeClock()
    svc, keys = _service(rng, breaker_threshold=2, breaker_cooldown_s=30.0,
                         breaker_clock=clk)
    q, exp = _queries(rng, keys)
    scen = FAULTS.inject(POINT_BACKEND_DISPATCH, always(backend="cuda"))
    assert np.array_equal(svc.lookup(q), exp)
    assert np.array_equal(svc.lookup(q), exp)
    assert svc.stats.fallback_lookups == 2
    assert svc.stats.breakers["cuda"] == OPEN
    trips_when_open = FAULTS.trips(POINT_BACKEND_DISPATCH)
    assert np.array_equal(svc.lookup(q), exp)    # open: cuda skipped
    assert FAULTS.trips(POINT_BACKEND_DISPATCH) == trips_when_open
    h = svc.health()
    assert h["degraded"] and h["fallback_lookups"] == 3
    assert h["breakers"]["cuda"]["state"] == OPEN
    assert h["armed_faults"] == {POINT_BACKEND_DISPATCH: 1}
    FAULTS.clear(POINT_BACKEND_DISPATCH)
    clk.advance(31.0)
    assert svc.health()["breakers"]["cuda"]["state"] == HALF_OPEN
    assert np.array_equal(svc.lookup(q), exp)
    assert svc.stats.breakers["cuda"] == CLOSED
    assert not svc.health()["degraded"]
    assert svc.stats.fallback_lookups == 3
    assert scen.kind == "always"


def test_chain_exhausted_raises_typed_never_wrong(rng):
    svc, keys = _service(rng, fallback=None)
    q, exp = _queries(rng, keys)
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="cuda")):
        with pytest.raises(BackendUnavailableError) as ei:
            svc.lookup(q)
        assert ei.value.chain == ("cuda",)
        assert isinstance(ei.value.last_error, InjectedFault)
    assert np.array_equal(svc.lookup(q), exp)


def test_explicit_chain_and_unknown_chain_names(rng):
    svc, keys = _service(rng, fallback=["numpy"])
    q, exp = _queries(rng, keys, 300, 30)
    assert svc.health()["fallback_chain"] == ["cuda", "numpy"]
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="cuda")):
        assert np.array_equal(svc.lookup(q), exp)
    with pytest.raises(ValueError, match="unknown backend"):
        _service(rng, n=5_000, fallback=["nope"])
    with pytest.raises(ValueError, match="fallback must be"):
        _service(rng, n=5_000, fallback="torch")


def test_host_backend_dispatch_point_fires(rng):
    svc, keys = _service(rng)
    q, exp = _queries(rng, keys, 200, 20)
    with FAULTS.injected(POINT_BACKEND_DISPATCH, fail_once(backend="numpy")):
        with pytest.raises(BackendUnavailableError):
            svc.lookup(q, backend="numpy")
    assert np.array_equal(svc.lookup(q, backend="numpy"), exp)


def test_factory_fault_falls_back_then_retries(rng):
    """A backend built at its first lookup (``torch`` here; the default
    backend's planes go up with the service): a factory fault falls back
    down its chain, and the next lookup builds it."""
    svc, keys = _service(rng)
    q, exp = _queries(rng, keys, 500, 50)
    with FAULTS.injected(POINT_BACKEND_FACTORY, fail_once(backend="torch")):
        assert np.array_equal(svc.lookup(q, backend="torch"), exp)
    assert svc.stats.fallback_lookups == 1
    assert np.array_equal(svc.lookup(q, backend="torch"), exp)
    assert svc.stats.fallback_lookups == 1


def test_unknown_backend_still_raises_value_error(rng):
    svc, _ = _service(rng, n=5_000, n_shards=1)
    with pytest.raises(ValueError, match="unknown backend"):
        svc.lookup(np.zeros(1, np.uint64), backend="nope")


def test_first_error_stays_first(rng):
    """The first error of the service's life (a library that failed to
    build, say) stays the first of ``health()["last_errors"]`` however many
    follow."""
    svc, keys = _service(rng, n=5_000, n_shards=1, breaker_threshold=100)
    q, _ = _queries(rng, keys, 100, 0)
    with FAULTS.injected(POINT_BACKEND_DISPATCH,
                         fail_once(backend="cuda", exc=OSError)):
        svc.lookup(q)
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="cuda")):
        for _ in range(20):
            svc.lookup(q)
    errors = svc.health()["last_errors"]
    assert len(errors) == 16 and errors[0].startswith("OSError")
    assert all(e.startswith("InjectedFault") for e in errors[1:])


def test_default_fallback_is_the_chain_on_the_cpu_only(rng):
    """Left unset, ``fallback`` is the chain on the CPU and none on the
    card, where a failed K1 must raise rather than be served by a plain
    version; asking for ``"auto"`` gives the chain on any device."""
    assert default_fallback("cpu") == "auto"
    assert default_fallback(torch.device("cuda", 0)) is None
    svc, _ = _service(rng, n=5_000, n_shards=1)
    assert svc.health()["fallback_chain"] == ["cuda", "torch", "numpy"]
    svc, _ = _service(rng, n=5_000, n_shards=1, fallback=None)
    assert svc.health()["fallback_chain"] == ["cuda"]


def test_warmup_raises_for_the_default_backend_only(rng):
    """A warm-up failure of the service's own backend is raised (and
    noted); another backend's is noted and left cold."""
    svc, keys = _service(rng, n=5_000, n_shards=1)
    with FAULTS.injected(POINT_BACKEND_DISPATCH,
                         fail_once(backend="cuda", exc=OSError)):
        with pytest.raises(OSError):
            svc.warmup()
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="torch")):
        svc.warmup("torch")
    errors = svc.health()["last_errors"]
    assert len(errors) == 2 and errors[0].startswith("OSError")
    assert errors[1].startswith("InjectedFault")
    q, exp = _queries(rng, keys, 200, 20)
    assert np.array_equal(svc.lookup(q), exp)
    assert svc.stats.fallback_lookups == 0


# ----------------------------------------------------------- queued path ----

def test_queue_dispatch_fault_fills_tickets_via_fallback(rng):
    svc, keys = _service(rng)
    q, exp = _queries(rng, keys, BLOCK * 2, 0)   # two full blocks
    with FAULTS.injected(POINT_BACKEND_DISPATCH, fail_n(1, backend="cuda")):
        t = svc.submit(q)
        out = t.result()
    assert np.array_equal(out, exp)
    assert svc.stats.backend_failures >= 1


def test_queue_total_failure_parks_typed_error_on_ticket(rng):
    svc, keys = _service(rng)
    q, _ = _queries(rng, keys, BLOCK, 0)
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always()):   # every backend
        t = svc.submit(q)
        svc.drain()
        assert t.ready
        with pytest.raises(BackendUnavailableError):
            t.result()
    q2, exp2 = _queries(rng, keys, 300, 30)
    assert np.array_equal(svc.submit(q2).result(), exp2)


def test_deadline_timer_flush_survives_dispatch_fault(rng):
    svc, keys = _service(rng, max_delay_s=0.01)
    q, exp = _queries(rng, keys, 100, 0)         # sub-block: timer flushes
    with FAULTS.injected(POINT_BACKEND_DISPATCH, fail_n(1, backend="cuda")):
        t = svc.submit(q)
        deadline = time.monotonic() + 5.0
        while not t.ready and time.monotonic() < deadline:
            time.sleep(0.005)
        assert t.ready, "deadline flush must fill the ticket despite faults"
    assert np.array_equal(t.result(), exp)


def test_queue_on_the_per_shard_path_answers_through_the_chain(rng):
    """Mixed-kind shards (no fused impl): ``submit`` fills at once, through
    the chain when the default backend fails."""
    from repro_torch.data import generate
    keys = generate("face", 100_000, 0)
    svc = PlexService(keys.copy(), 32, n_shards=2, block=BLOCK, device="cpu")
    assert not svc.fused
    q, exp = _queries(rng, keys, 700, 0)
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="cuda")):
        assert np.array_equal(svc.submit(q).result(), exp)
    assert svc.stats.fallback_lookups == 1


def test_admission_control_reject_and_shed(rng):
    svc, keys = _service(rng, max_queue=256, max_delay_s=60.0)
    q1 = keys[:200].copy()
    t1 = svc.submit(q1)
    with pytest.raises(QueueFullError):
        svc.submit(keys[:100].copy())
    assert svc.stats.shed_queries == 100
    assert np.array_equal(t1.result(), np.searchsorted(keys, q1))

    svc2, keys2 = _service(rng, max_queue=256, overflow="shed",
                           max_delay_s=60.0)
    t2 = svc2.submit(keys2[:200].copy())
    shed = svc2.submit(keys2[:100].copy())
    assert shed.ready
    with pytest.raises(QueueFullError):
        shed.result()
    assert np.array_equal(t2.result(), np.searchsorted(keys2, keys2[:200]))


def test_drain_timeout_on_wedged_lock(rng):
    svc, keys = _service(rng, max_delay_s=60.0)
    t = svc.submit(keys[:64].copy())
    holding = threading.Event()
    release = threading.Event()

    def hold():
        with svc._lock:
            holding.set()
            release.wait(5.0)

    thr = threading.Thread(target=hold, daemon=True)
    thr.start()
    assert holding.wait(5.0)
    with pytest.raises(TimeoutError):
        svc.drain(timeout=0.05)
    with pytest.raises(TimeoutError):
        t.result(timeout=0.05)
    release.set()
    thr.join(5.0)
    assert not thr.is_alive()
    assert np.array_equal(t.result(timeout=5.0),
                          np.searchsorted(keys, keys[:64]))


def test_close_is_idempotent_and_context_managed(rng, tmp_path):
    svc, keys = _service(rng, n=10_000)
    svc.save(tmp_path, fsync=False)
    svc.close()
    svc.close()
    assert not svc.durable
    with PlexService.open(tmp_path, fsync=False, device="cpu") as back:
        assert back.durable
        assert np.array_equal(back.lookup(keys[:100]),
                              np.searchsorted(keys, keys[:100]))
    assert not back.durable
    assert back.health()["closed"]


# ---------------------------------------------------------- merge isolation ----

def test_merge_failure_isolated_old_state_bit_identical(rng):
    svc, keys = _service(rng, merge_threshold=64, merge_backoff_s=0.0)
    state_before = svc._state
    ins = rng.integers(0, 1 << 62, 100, dtype=np.uint64)
    with FAULTS.injected(POINT_MERGE_BUILD, fail_once()):
        svc.insert(ins)
    assert FAULTS.trips(POINT_MERGE_BUILD) == 1
    assert svc.stats.merge_failures == 1 and svc.stats.merges == 0
    assert svc._state.snapshot is state_before.snapshot
    model = np.sort(np.concatenate([keys, ins]))
    q, exp = _queries(rng, model)
    assert np.array_equal(svc.lookup(q), exp)
    more = rng.integers(0, 1 << 62, 8, dtype=np.uint64)
    svc.insert(more)
    assert svc.stats.merges == 1 and svc.n_pending == 0
    model = np.sort(np.concatenate([model, more]))
    q, exp = _queries(rng, model)
    assert np.array_equal(svc.lookup(q), exp)


def test_explicit_merge_raises_typed_and_backs_off(rng):
    svc, keys = _service(rng, merge_threshold=0, merge_backoff_s=10.0)
    svc.insert(rng.integers(0, 1 << 62, 50, dtype=np.uint64))
    with FAULTS.injected(POINT_MERGE_BUILD, fail_once()):
        with pytest.raises(MergeFailedError):
            svc.merge()
    h = svc.health()
    assert h["merge_failures"] == 1 and h["degraded"]
    assert h["merge_retry_in_s"] > 0
    assert svc.merge()
    assert not svc.health()["degraded"]


def test_merge_worker_death_is_contained(rng):
    """A trip at the background worker's wakeup kills the worker; the
    backoff arms, the live state serves on, and the next update starts a
    fresh worker that merges."""
    svc, keys = _service(rng, merge_threshold=64, merge_mode="background",
                         merge_backoff_s=0.0)
    ins = rng.integers(0, 1 << 62, 100, dtype=np.uint64)
    with FAULTS.injected(POINT_MERGE_WORKER, fail_once()):
        svc.insert(ins)
        deadline = time.monotonic() + 10.0
        while svc.stats.merge_failures == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
    assert svc.stats.merge_failures == 1 and svc.stats.merges == 0
    svc._merge_worker.join(5.0)
    assert not svc.health()["merge_worker_alive"]
    model = np.sort(np.concatenate([keys, ins]))
    q, exp = _queries(rng, model)
    assert np.array_equal(svc.lookup(q), exp)
    svc.insert(np.asarray([3], np.uint64))
    deadline = time.monotonic() + 10.0
    while svc.stats.merges == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert svc.stats.merges == 1
    svc.close()


def test_durable_commit_fault_leaves_disk_and_memory_untouched(rng,
                                                               tmp_path):
    svc, keys = _service(rng, n=10_000, merge_threshold=0)
    svc.save(tmp_path, fsync=False)
    listing_before = sorted(p.name for p in tmp_path.iterdir())
    svc.insert(rng.integers(0, 1 << 62, 40, dtype=np.uint64))
    for exc in (None, OSError):
        scen = fail_once() if exc is None else fail_once(exc=exc)
        with FAULTS.injected(POINT_MANIFEST_COMMIT, scen):
            with pytest.raises(MergeFailedError):
                svc.merge()
        assert sorted(p.name for p in tmp_path.iterdir()) == listing_before
        assert svc.generation == 0 and svc.n_pending == 40
    assert svc.merge()
    assert svc.generation == 1
    model = svc.logical_keys()
    back = PlexService.open(tmp_path, fsync=False, device="cpu")
    q, exp = _queries(rng, np.asarray(model))
    assert np.array_equal(back.lookup(q), exp)
    back.close()
    svc.close()


def test_save_seed_fault_aborts_commit_cleanly(rng, tmp_path):
    svc, keys = _service(rng, n=10_000)
    ins = rng.integers(0, 1 << 62, 30, dtype=np.uint64)
    svc.insert(ins)
    with FAULTS.injected(POINT_WAL_APPEND, fail_once()):
        with pytest.raises(InjectedFault):
            svc.save(tmp_path, fsync=False)
    assert not svc.durable
    assert sorted(p.name for p in tmp_path.iterdir()) == []
    svc.save(tmp_path, fsync=False)
    assert svc.durable and svc.generation == 0
    svc.close()
    back = PlexService.open(tmp_path, fsync=False, device="cpu")
    model = np.sort(np.concatenate([keys, ins]))
    assert np.array_equal(np.asarray(back.logical_keys()), model)
    back.close()


def test_wal_append_fault_keeps_served_state_consistent(rng, tmp_path):
    """WAL before mutation: an append fault loses the update on both sides;
    an fsync fault comes after the record was written and flushed, so the
    update is durable but not served, and recovery replays it."""
    svc, keys = _service(rng, n=10_000)
    svc.save(tmp_path, fsync=True)
    pending_before = svc.n_pending
    with FAULTS.injected(POINT_WAL_APPEND, fail_once()):
        with pytest.raises(InjectedFault):
            svc.insert(np.asarray([1], dtype=np.uint64))
    assert svc.n_pending == pending_before
    with FAULTS.injected(POINT_WAL_FSYNC, fail_once()):
        with pytest.raises(InjectedFault):
            svc.insert(np.asarray([2], dtype=np.uint64))
    assert svc.n_pending == pending_before
    svc.insert(np.asarray([3], dtype=np.uint64))
    svc.close()
    back = PlexService.open(tmp_path, fsync=False, device="cpu")
    model = np.sort(np.concatenate(
        [keys, np.asarray([2, 3], dtype=np.uint64)]))
    assert np.array_equal(back.logical_keys(), model)
    back.close()


# ----------------------------------------------------- last-known-good open ----

def _two_generations(rng, tmp_path, n=10_000):
    """A durable store retaining generations 0 and 1 (keep_generations=2)."""
    svc, keys = _service(rng, n=n, merge_threshold=0, keep_generations=2)
    svc.save(tmp_path, fsync=False)
    ins = rng.integers(0, 1 << 62, 200, dtype=np.uint64)
    svc.insert(ins)
    assert svc.merge() and svc.generation == 1
    model = np.asarray(svc.logical_keys())
    svc.close()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert gen_name(0) in names and gen_name(1) in names
    assert wal_name(0) in names and wal_name(1) in names
    return model


def test_keep_generations_retains_fallback_candidates(rng, tmp_path):
    _two_generations(rng, tmp_path)


def test_open_falls_back_to_last_known_good_on_map_fault(rng, tmp_path):
    model = _two_generations(rng, tmp_path)
    with FAULTS.injected(POINT_SNAPSHOT_MAP,
                         fail_once(gen_dir=gen_name(1))):
        back = PlexService.open(tmp_path, fsync=False, device="cpu")
    assert back.generation == 0
    assert np.array_equal(np.asarray(back.logical_keys()), model)
    q, exp = _queries(rng, model)
    assert np.array_equal(back.lookup(q), exp)
    qdir = tmp_path / QUARANTINE_DIR
    assert (qdir / gen_name(1)).is_dir()
    assert read_manifest(tmp_path).generation == 0
    back.insert(np.asarray([7], dtype=np.uint64))
    assert back.merge() and back.generation == 1
    back.close()
    again = PlexService.open(tmp_path, fsync=False, device="cpu")
    assert again.generation == 1
    again.close()


def test_open_recovers_from_real_corruption(rng, tmp_path):
    model = _two_generations(rng, tmp_path)
    (tmp_path / gen_name(1) / "snapshot.plex").write_bytes(b"garbage")
    back = PlexService.open(tmp_path, fsync=False, device="cpu")
    assert back.generation == 0
    assert np.array_equal(np.asarray(back.logical_keys()), model)
    back.close()


def test_open_no_servable_generation_raises_typed(rng, tmp_path):
    svc, _ = _service(rng, n=5_000, n_shards=1)
    svc.save(tmp_path, fsync=False)
    svc.close()
    (tmp_path / gen_name(0) / "snapshot.plex").write_bytes(b"garbage")
    with pytest.raises(Exception) as ei:
        PlexService.open(tmp_path, fsync=False, recover=False, device="cpu")
    assert not isinstance(ei.value, NoServableGenerationError)
    with pytest.raises(NoServableGenerationError):
        PlexService.open(tmp_path, fsync=False, device="cpu")
    assert (tmp_path / QUARANTINE_DIR / gen_name(0)).is_dir()


def test_open_missing_manifest_still_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        PlexService.open(tmp_path, device="cpu")


# ----------------------------------------------------------------- health ----

def test_health_is_json_and_tracks_wal(rng, tmp_path):
    """``health()`` carries the reference's keys (less ``slo``, which comes
    with the port's tracing) and the port's counts of the queue's deadline
    timer, and tracks the WAL."""
    svc, _ = _service(rng, n=10_000)
    ref = RService(sorted_u64(rng, 5_000), eps=32, block=BLOCK)
    h0 = svc.health()
    json.dumps(h0)
    assert set(h0) == (set(ref.health()) - {"slo"}) | {
        "timers_started", "deadline_threads", "deadline_flushes",
        "deadline_idle"}
    assert h0["generation"] == -1 and h0["wal_bytes"] == 0
    assert h0["routed_devices"] == 0
    svc.save(tmp_path, fsync=False)
    svc.insert(np.asarray([5], dtype=np.uint64))
    h1 = svc.health()
    json.dumps(h1)
    assert h1["generation"] == 0 and h1["wal_bytes"] > 0
    assert h1["n_pending"] == 1
    assert set(h1["breakers"]) == set(h1["fallback_chain"])
    svc.close()


# ------------------------------------------------------------- on the card ----

@pytest.mark.gpu
def test_chaos_falls_back_to_torch_on_card():
    """On a CUDA card: with every ``cuda`` dispatch failing, the chain
    serves through the ``torch`` backend's plain pipeline on the card
    (no K1 launch, every rank equal to searchsorted), and K1 launches
    resume once the fault is cleared (``python3 chip_smoke.py``'s
    ``chaos`` phase does the same at 16M keys)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    keys = sorted_u64(rng, 1 << 20)
    svc = PlexService(keys.copy(), eps=64, block=1 << 14, fallback="auto",
                      device="cuda")
    q, exp = _queries(rng, keys, 1 << 16, 1 << 12)
    SL.launches = SL.plain_calls = 0
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="cuda")):
        assert np.array_equal(svc.lookup(q), exp)
    assert SL.launches == 0 and SL.plain_calls > 0
    st = svc.snapshot.stacked_impl("torch", block=1 << 14)
    assert st.plain and st.planes.device.type == "cuda"
    assert svc.stats.fallback_lookups == 1
    assert np.array_equal(svc.lookup(q), exp)
    assert SL.launches > 0
    svc.close()


@pytest.mark.gpu
def test_default_service_on_card_raises_when_k1_fails(monkeypatch):
    """On a CUDA card a service left at its default fallback serves
    nothing in K1's place: with K1's library failing to load, ``warmup``
    and ``lookup`` raise, neither the plain pipeline nor the host answers,
    and the load error is the first of ``health()``'s errors. Once the
    library loads again, K1 serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    keys = sorted_u64(rng, 1 << 18)
    svc = PlexService(keys.copy(), eps=64, block=1 << 14, device="cuda")
    assert svc.health()["fallback_chain"] == ["cuda"]
    q, exp = _queries(rng, keys, 1 << 14, 1 << 10)

    def no_library(name):
        raise OSError(f"{name}: the kernel library failed to build")
    monkeypatch.setattr(SL, "load_library", no_library)
    SL.launches = SL.plain_calls = 0
    with pytest.raises(OSError):
        svc.warmup()
    with pytest.raises(BackendUnavailableError):
        svc.lookup(q)
    assert SL.launches == 0 and SL.plain_calls == 0
    assert svc.stats.fallback_lookups == 0
    assert svc.health()["last_errors"][0].startswith("OSError")
    monkeypatch.undo()
    assert np.array_equal(svc.lookup(q), exp)
    assert SL.launches > 0 and SL.plain_calls == 0
    svc.close()
