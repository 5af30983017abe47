"""``submit``/``drain`` in the port, held against the reference's.

The scenarios of ``tests/test_stacked_serving.py`` (tickets and stats, the
deadline flush, ``result()`` draining) and of ``tests/test_updatable.py``
(updates drain the queue first, the timer thread fills tickets, ``drain``
cancels the timer), plus admission control (``max_queue`` with reject and
shed) and the per-shard path, where ``submit`` answers at once. The port
serves every deadline from one long-lived thread a service, where the
reference starts a ``threading.Timer`` an arm: its life and its waits are
tested here too. The port
launches only the lanes it has, so ``padded_lanes`` stays 0 where the
reference pads a block.
"""
import gc
import threading
import time

import numpy as np
import pytest

from repro.data import generate
from repro.serving import PlexService as RService
from repro_torch.obs.metrics import METRICS
from repro_torch.obs.trace import TRACE
from repro_torch.resilience.errors import QueueFullError
from repro_torch.serving import PlexService
from repro_torch.serving.plex_service import _DEADLINE_IDLE_S

from conftest import sorted_u64


@pytest.fixture(autouse=True)
def _reset_registry():
    yield
    METRICS.reset()
    METRICS.disable()


@pytest.fixture
def traced():
    """``TRACE`` armed for one test, cleared before and after."""
    TRACE.clear()
    TRACE.enable()
    yield TRACE
    TRACE.disable()
    TRACE.clear()


def _svc(keys, **kw):
    kw.setdefault("eps", 16)
    kw.setdefault("block", 512)
    return PlexService(keys.copy(), device="cpu", **kw)


def test_submit_drain_tickets_and_stats(rng):
    keys = sorted_u64(rng, 30_000)
    svc = _svc(keys, n_shards=3, max_delay_s=60.0)
    ref = RService(keys.copy(), eps=16, n_shards=3, block=512,
                   max_delay_s=60.0, backend="jnp")
    assert svc.fused
    svc.warmup()
    qs = [keys[:300], keys[5_000:5_900], keys[-100:]]
    tickets = [svc.submit(q) for q in qs]
    rtickets = [ref.submit(q) for q in qs]
    # 1,300 queued queries: two full blocks launched, 276 still queued
    assert svc.stats.inflight_batches == ref.stats.inflight_batches == 2
    assert not tickets[-1].ready
    svc.drain()
    ref.drain()
    assert svc.stats.inflight_batches == 0
    assert svc.stats.drained_batches == 3
    assert svc.stats.batches == 3 and svc.stats.queries == 1_300
    assert svc.stats.padded_lanes == 0 < ref.stats.padded_lanes
    for t, rt, q in zip(tickets, rtickets, qs):
        assert t.ready
        assert np.array_equal(t.result(), np.searchsorted(keys, q, "left"))
        assert np.array_equal(t.result(), rt.result())


def test_submit_deadline_flush(rng):
    keys = sorted_u64(rng, 10_000)
    svc = _svc(keys, max_delay_s=0.0)
    svc.submit(keys[:100])
    svc.submit(keys[100:200])      # deadline 0: the remainder launches
    assert svc.stats.inflight_batches >= 1
    svc.drain()
    assert svc.stats.inflight_batches == 0
    # each submit launched its own remainder: no timer was needed
    assert (svc.stats.timers_started, svc.stats.deadline_flushes,
            svc.stats.deadline_idle) == (0, 0, 0)


def test_ticket_result_triggers_drain(rng):
    keys = sorted_u64(rng, 10_000)
    svc = _svc(keys, max_delay_s=60.0)
    t = svc.submit(keys[:100])
    assert not t.ready
    assert np.array_equal(t.result(),
                          np.searchsorted(keys, keys[:100], "left"))
    assert svc.submit(np.zeros(0, np.uint64)).result().size == 0


def test_updates_drain_queue_first(rng):
    """Queued lookups observe the state they were submitted against: an
    insert linearises after every earlier ticket."""
    keys = np.unique(rng.integers(1, 1 << 62, 10_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=60.0, merge_threshold=0)
    svc.warmup()
    t = svc.submit(keys[:100])
    assert not t.ready
    svc.insert(keys[:1] - np.uint64(1))
    assert t.ready                          # drained by the update
    assert np.array_equal(t.result(), np.arange(100))
    t2 = svc.submit(keys[:100])
    svc.delete(keys[:1])
    assert np.array_equal(t2.result(), np.arange(1, 101))


def test_background_deadline_flush_fills_tickets(rng):
    keys = np.unique(rng.integers(0, 1 << 62, 10_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=0.05)
    svc.warmup()
    t = svc.submit(keys[:100])
    assert not t.ready
    deadline = time.monotonic() + 5.0
    # filled by the timer thread's flush and drain, no caller action
    while t._filled < t.n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert t.ready, "the deadline timer did not flush the queued remainder"
    assert t._filled == 100
    assert np.array_equal(t.result(), np.arange(100))
    assert svc.stats.inflight_batches == 0
    # one pass did the work; a pass woken before the deadline re-armed
    assert svc.stats.deadline_flushes == 1
    assert svc.stats.timers_started == 1 + svc.stats.deadline_idle
    assert svc.health()["deadline_flushes"] == 1


def _wait_filled(tickets, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while (any(t._filled < t.n for t in tickets)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return all(t._filled == t.n for t in tickets)


def test_deadline_timer_drains_whole_blocks(rng):
    """A submit that fills whole blocks leaves nothing queued: the timer
    still drains the launched blocks, with no further call."""
    keys = np.unique(rng.integers(0, 1 << 62, 10_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=0.05)
    svc.warmup()
    t = svc.submit(keys[:1024])                 # two blocks of 512
    assert _wait_filled([t]), "launched blocks left undrained"
    assert np.array_equal(t.result(), np.arange(1024))
    assert svc.stats.inflight_batches == 0
    assert (svc.stats.timers_started, svc.stats.deadline_flushes,
            svc.stats.deadline_idle) == (1, 1, 0)


def test_deadline_timer_drains_a_late_submits_flush(rng):
    """The timer fires while a submit holds the lock; that submit finds the
    queued remainder past its deadline and launches it itself. The pending
    timer then finds the queue empty and must still drain the launches."""
    keys = np.unique(rng.integers(0, 1 << 62, 10_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=0.05)
    svc.warmup()
    with svc._lock:
        t1 = svc.submit(keys[:100])             # arms the timer
        time.sleep(0.2)                         # it fires, waits on the lock
        t2 = svc.submit(keys[100:200])          # past the deadline: launches
        assert svc._q_len == 0 and svc.stats.inflight_batches == 1
    assert _wait_filled([t1, t2]), "the pending timer did not drain"
    assert np.array_equal(t1.result(), np.arange(100))
    assert np.array_equal(t2.result(), np.arange(100, 200))
    assert svc.stats.inflight_batches == 0
    # the late submit launched; the pending timer found only the drain
    assert (svc.stats.timers_started, svc.stats.deadline_flushes,
            svc.stats.deadline_idle) == (1, 1, 0)


def test_drain_counts_a_blocks_cache_hits_as_the_batched_sync(rng):
    """The drain reads one block's hit count as it is; a synchronous
    lookup concatenates its blocks' counts: the same launches count the
    same hits and lanes."""
    keys = sorted_u64(rng, 30_000)
    q = np.concatenate([keys[:700], keys[:324]])   # repeats: the cache hits
    a = _svc(keys, max_delay_s=60.0, cache_slots=1 << 12)
    b = _svc(keys, max_delay_s=60.0, cache_slots=1 << 12)
    for _ in range(2):
        a.lookup(q)
        assert np.array_equal(b.submit(q).result(),
                              np.searchsorted(keys, q, "left"))
    assert a.stats.cache_queries == b.stats.cache_queries == 2 * q.size
    assert a.stats.cache_hits == b.stats.cache_hits > 0


def test_drain_cancels_timer(rng):
    keys = np.unique(rng.integers(0, 1 << 62, 5_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=30.0)
    t = svc.submit(keys[:64])
    assert svc._deadline is not None
    svc.drain()
    assert svc._deadline is None
    assert t.ready
    assert (svc.stats.timers_started, svc.stats.deadline_flushes,
            svc.stats.deadline_idle) == (1, 0, 0)


# -- the deadline thread ------------------------------------------------------

def test_one_deadline_thread_serves_every_arm(rng):
    """50 whole-block requests arm 50 deadlines, all on the one deadline
    thread the first arm started: no thread is started a request."""
    keys = sorted_u64(rng, 30_000)
    before = threading.active_count()
    svc = _svc(keys, max_delay_s=60.0)
    svc.warmup()
    for i in range(50):
        q = keys[i * 512:(i + 1) * 512]
        assert np.array_equal(svc.submit(q).result(),
                              np.searchsorted(keys, q, "left"))
        assert threading.active_count() <= before + 1
    assert svc.stats.timers_started == 50
    assert svc.stats.deadline_threads == 1
    assert svc.health()["deadline_threads"] == 1
    svc.close()


@pytest.mark.parametrize("end", ["close", "collect"])
def test_deadline_thread_ends_with_its_service(rng, end):
    """``close()`` joins the deadline thread (a second close is a no-op); an
    unclosed service that is collected lets it end within a few idle
    waits, since the thread holds the service only weakly."""
    keys = sorted_u64(rng, 10_000)
    svc = _svc(keys, max_delay_s=60.0)
    t = svc.submit(keys[:100])                  # arms: the thread starts
    th = svc._deadline_thread
    assert th is not None and th.is_alive()
    assert np.array_equal(t.result(), np.searchsorted(keys, keys[:100]))
    if end == "close":
        svc.close()
        assert not th.is_alive()
        svc.close()
        assert svc.health()["closed"] and svc._deadline_thread is th
    else:
        del svc, t
        gc.collect()
        th.join(4 * _DEADLINE_IDLE_S)
    assert not th.is_alive()


def test_an_idle_deadline_thread_meets_a_new_deadline(rng):
    """After the thread has idled through several waits, a partial
    remainder still launches within ``max_delay_s``, with no caller action:
    the arm wakes a thread whose idle wait would end later."""
    keys = np.unique(rng.integers(0, 1 << 62, 10_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=0.05)
    svc.warmup()
    t1 = svc.submit(keys[:100])                 # starts the thread
    assert _wait_filled([t1]), "the deadline thread did not fill the ticket"
    time.sleep(3.5 * _DEADLINE_IDLE_S)          # several idle waits
    # submit with at least half an idle wait left, so a wait left to run
    # out would miss the deadline by far more than the slack below
    until = time.monotonic() + 5 * _DEADLINE_IDLE_S
    while time.monotonic() < until and (
            svc._sleep_until is None
            or svc._sleep_until - time.monotonic() < _DEADLINE_IDLE_S / 2):
        time.sleep(0.005)
    t0 = time.monotonic()
    t2 = svc.submit(keys[100:200])
    assert _wait_filled([t2], timeout_s=5.0)
    assert time.monotonic() - t0 < svc.max_delay_s + 0.3
    assert np.array_equal(t2.result(), np.arange(100, 200))
    # the idle waits counted nothing: two arms, two passes, one thread
    assert (svc.stats.timers_started, svc.stats.deadline_threads,
            svc.stats.deadline_flushes, svc.stats.deadline_idle) == \
        (2, 1, 2, 0)
    svc.close()


# -- spans inside a served request -------------------------------------------

def _inside(child, parent, slack_s=1e-6) -> bool:
    """``child``'s interval lies in ``parent``'s (t0 and dur_us)."""
    return (parent["t0"] - slack_s <= child["t0"] and
            child["t0"] + child["dur_us"] / 1e6
            <= parent["t0"] + parent["dur_us"] / 1e6 + slack_s)


def _tags(e) -> set:
    a = e.get("attrs", {})
    return set(a.get("reqs", ())) | ({a["req"]} if "req" in a else set())


SUBMIT_CHILDREN = {"serve.lock", "serve.take", "serve.staging",
                   "serve.dispatch", "serve.timer"}
DRAIN_CHILDREN = {"serve.lock", "serve.timer", "serve.drain.wait",
                  "serve.copy_back", "serve.cache_count", "serve.fill"}


def test_traced_request_spans_nest_and_carry_its_id(rng, traced):
    """A traced ``submit(...).result()`` of one whole block: every span of
    the request's tree, each child inside its parent's interval, each
    carrying the ticket's id."""
    keys = sorted_u64(rng, 30_000)
    svc = _svc(keys, max_delay_s=60.0, cache_slots=1 << 12)
    svc.warmup()
    traced.clear()
    q = keys[1_000:1_512]
    t = svc.submit(q)
    assert np.array_equal(t.result(), np.arange(1_000, 1_512))
    assert svc.stats.cache_queries == 512        # one block's lanes counted
    evs = traced.events()
    by_id = {e["id"]: e for e in evs}
    assert traced.dropped == 0

    def children(root):
        return [e for e in evs if e["parent"] == root["id"]]

    (submit,) = [e for e in evs if e["name"] == "serve.submit"]
    (drain,) = [e for e in evs if e["name"] == "serve.drain"]
    assert submit["parent"] is None and drain["parent"] is None
    assert {e["name"] for e in children(submit)} == SUBMIT_CHILDREN
    assert {e["name"] for e in children(drain)} == DRAIN_CHILDREN
    (take,) = [e for e in children(submit) if e["name"] == "serve.take"]
    assert [e["name"] for e in children(take)] == ["serve.queue_wait"]
    (dispatch,) = [e for e in evs if e["name"] == "serve.dispatch"]
    assert dispatch["attrs"]["path"] == "queue"
    assert [e["attrs"]["op"] for e in evs
            if e["name"] == "serve.timer"] == ["start", "cancel"]
    for e in evs:
        if e["parent"] is not None:
            assert _inside(e, by_id[e["parent"]]), e["name"]
        assert _tags(e) == {t.id}, e
    assert submit["attrs"]["req"] == drain["attrs"]["req"] == t.id


def test_two_tickets_in_one_block_share_its_spans(rng, traced):
    keys = sorted_u64(rng, 30_000)
    svc = _svc(keys, max_delay_s=60.0)
    svc.warmup()
    t1 = svc.submit(keys[:300])                  # queued
    t2 = svc.submit(keys[300:512])               # fills the block: launched
    assert svc.stats.inflight_batches == 1 and t2.id == t1.id + 1
    svc.drain()
    evs = traced.events()
    for name in ("serve.take", "serve.staging", "serve.dispatch",
                 "serve.drain.wait", "serve.copy_back",
                 "serve.cache_count", "serve.fill"):
        (e,) = [e for e in evs if e["name"] == name]
        assert e["attrs"]["reqs"] == [t1.id, t2.id], name
    waits = [e for e in evs if e["name"] == "serve.queue_wait"]
    assert [e["attrs"]["req"] for e in waits] == [t1.id, t2.id]
    # the block launched inside the second submit, the drain untagged
    (take,) = [e for e in evs if e["name"] == "serve.take"]
    submits = {e["id"]: e for e in evs if e["name"] == "serve.submit"}
    assert submits[take["parent"]]["attrs"]["req"] == t2.id
    (drain,) = [e for e in evs if e["name"] == "serve.drain"]
    assert drain["attrs"]["req"] is None
    assert np.array_equal(t1.result(), np.arange(300))
    assert np.array_equal(t2.result(), np.arange(300, 512))


def test_deadline_flush_spans_carry_the_tickets_ids(rng, traced):
    """A remainder answered by the timer thread: its launch and drain nest
    in ``serve.deadline_flush`` on that thread, tagged with the ticket."""
    keys = np.unique(rng.integers(0, 1 << 62, 10_000, dtype=np.uint64))
    svc = _svc(keys, max_delay_s=0.05)
    svc.warmup()
    t = svc.submit(keys[:100])
    assert _wait_filled([t]), "the deadline timer did not fill the ticket"
    assert np.array_equal(t.result(), np.arange(100))
    evs = traced.events()
    flushes = [e for e in evs if e["name"] == "serve.deadline_flush"]
    (flush,) = [e for e in flushes if e["attrs"]["work"]]
    assert len(flushes) == svc.stats.deadline_flushes + \
        svc.stats.deadline_idle
    assert flush["thread"] != threading.current_thread().name
    inside = [e for e in evs if e["parent"] == flush["id"]]
    assert {e["name"] for e in inside} == {
        "serve.lock", "serve.take", "serve.staging", "serve.dispatch",
        "serve.drain.wait", "serve.copy_back", "serve.cache_count",
        "serve.fill"}
    for e in inside:
        if e["name"] != "serve.lock":
            assert _tags(e) == {t.id}, e
        assert _inside(e, flush) and e["thread"] == flush["thread"]
    (submit,) = [e for e in evs if e["name"] == "serve.submit"]
    assert submit["attrs"]["req"] == t.id
    assert [e["attrs"]["req"] for e in evs
            if e["name"] == "serve.timer"][:1] == [t.id]


def test_drain_timeout_on_a_held_lock(rng):
    keys = sorted_u64(rng, 5_000)
    svc = _svc(keys, max_delay_s=30.0)
    t = svc.submit(keys[:10])
    held, release = threading.Event(), threading.Event()

    def hold():
        with svc._lock:
            held.set()
            release.wait(10)
    th = threading.Thread(target=hold)
    th.start()
    try:
        assert held.wait(10)
        with pytest.raises(TimeoutError, match="lock"):
            svc.drain(timeout=0.05)
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)
    finally:
        release.set()
        th.join(10)
    assert not th.is_alive()
    assert np.array_equal(t.result(), np.searchsorted(keys, keys[:10]))


@pytest.mark.parametrize("overflow", ["reject", "shed"])
def test_max_queue_admission(rng, overflow):
    keys = sorted_u64(rng, 10_000)
    svc = _svc(keys, max_delay_s=60.0, max_queue=600, overflow=overflow)
    t1 = svc.submit(keys[:400])              # queued, under the bound
    if overflow == "reject":
        with pytest.raises(QueueFullError, match="queue"):
            svc.submit(keys[:300])
    else:
        shed = svc.submit(keys[:300])
        assert shed.ready
        with pytest.raises(QueueFullError):
            shed.result()
    assert svc.stats.shed_queries == 300
    t2 = svc.submit(keys[400:600])           # exactly at the bound
    assert np.array_equal(t1.result(), np.arange(400))
    assert np.array_equal(t2.result(), np.arange(400, 600))
    with pytest.raises(ValueError, match="overflow"):
        _svc(keys, overflow="drop")
    with pytest.raises(ValueError, match="max_queue"):
        _svc(keys, max_queue=-1)


def test_per_shard_path_answers_submit_at_once():
    keys = generate("face", 100_000, 0)
    svc = _svc(keys, eps=32, n_shards=2, max_delay_s=60.0)
    assert not svc.fused
    q = keys[np.random.default_rng(1).integers(0, keys.size, 700)]
    t = svc.submit(q)
    assert t.ready and t._filled == q.size
    assert svc._q_len == 0 and svc._deadline is None
    assert np.array_equal(t.result(), np.searchsorted(keys, q, "left"))


def test_many_callers_share_micro_batches(rng):
    """Tickets of mixed sizes from several threads: every answer exact,
    every block but the last full (shared across callers), nothing left in
    flight."""
    keys = generate("amzn", 40_000, 0)
    svc = _svc(keys, n_shards=2, max_delay_s=60.0, cache_slots=1 << 12)
    assert svc.fused
    svc.warmup()
    sizes = np.random.default_rng(2).integers(1, 1_500, 48)
    qs = [keys[np.random.default_rng(i).integers(0, keys.size, n)]
          for i, n in enumerate(sizes)]
    tickets: list = [None] * len(qs)

    def caller(lo):
        for i in range(lo, len(qs), 4):
            tickets[i] = svc.submit(qs[i])
    threads = [threading.Thread(target=caller, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    svc.drain()
    for t, q in zip(tickets, qs):
        assert np.array_equal(t.result(), np.searchsorted(keys, q, "left"))
    assert svc.stats.inflight_batches == 0
    assert svc.stats.batches == -(-int(sizes.sum()) // 512)
    assert svc.stats.queries == svc.stats.cache_queries == int(sizes.sum())
