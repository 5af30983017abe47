"""``merge_mode="background"`` in the port: the scenarios of
``tests/test_background_merge.py`` without durability.

Updates never wait on an in-flight rebuild; mutations made while it runs
land in the op journal and are replayed into the fresh delta at publish; a
failed rebuild (``Snapshot.build`` monkeypatched to fail, where the
reference injects a fault) is contained with a backoff and retried, and a
worker that dies is replaced on the next update; ``close()`` lets an
in-flight merge finish and joins the worker. Lookups are held against
``np.searchsorted`` over the logical keys and against the reference's
background-merging service.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from repro.serving import PlexService as RService
from repro_torch.core.index import Snapshot
from repro_torch.resilience.errors import MergeFailedError
from repro_torch.serving import PlexService


def _keys(n: int = 60_000, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 2**62, n, dtype=np.uint64))


def wait_for(pred, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _svc(keys, **kw):
    kw.setdefault("merge_mode", "background")
    kw.setdefault("merge_threshold", 256)
    kw.setdefault("block", 512)
    return PlexService(keys.copy(), 32, device="cpu", **kw)


def _worker_alive(svc) -> bool:
    w = svc._merge_worker
    return w is not None and w.is_alive()


def _slow_merges(monkeypatch, seconds: float) -> threading.Event:
    """Make every merge's ``Snapshot.build`` (epoch > 0) sleep first;
    returns the event set when one starts."""
    orig = Snapshot.build.__func__
    started = threading.Event()

    def slow_build(cls, *a, **kw):
        if kw.get("epoch", 0) > 0:
            started.set()
            time.sleep(seconds)
        return orig(cls, *a, **kw)
    monkeypatch.setattr(Snapshot, "build", classmethod(slow_build))
    return started


def test_merge_mode_validation():
    with pytest.raises(ValueError, match="merge_mode"):
        PlexService(_keys(1000), 32, merge_mode="async", device="cpu")


def test_threshold_triggers_background_merge():
    keys = _keys()
    with _svc(keys) as svc:
        ins = np.random.default_rng(0).integers(0, 2**62, 300,
                                                dtype=np.uint64)
        svc.insert(ins)
        assert wait_for(lambda: svc.stats.merges == 1)
        assert wait_for(lambda: svc.n_pending == 0)
        logical = np.sort(np.concatenate([keys, ins]))
        q = logical[::37]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))
        assert svc.epoch == svc.stats.epoch == 1
        assert len(svc._op_journal) == 0
        assert svc.stats.merge_s > 0


def test_updates_never_block_on_inflight_merge(monkeypatch):
    """While the worker holds a slowed rebuild, insert, delete, lookup and
    submit all complete without waiting for it."""
    keys = _keys()
    started = _slow_merges(monkeypatch, 1.0)
    svc = _svc(keys)
    rng = np.random.default_rng(1)
    try:
        svc.insert(rng.integers(0, 2**62, 300, dtype=np.uint64))
        assert started.wait(10.0), "merge never started"
        t0 = time.monotonic()
        svc.insert(rng.integers(0, 2**62, 10, dtype=np.uint64))
        svc.delete(keys[:3])
        svc.lookup(keys[::997])
        svc.submit(keys[::499]).result()
        elapsed = time.monotonic() - t0
        assert elapsed < 0.5, (f"serving-path calls took {elapsed:.2f}s "
                               "during an in-flight background merge")
        assert wait_for(lambda: svc.stats.merges >= 1)
    finally:
        svc.close()


def test_mid_merge_mutations_survive_via_residual_journal(monkeypatch):
    keys = _keys()
    started = _slow_merges(monkeypatch, 0.4)
    svc = _svc(keys)
    rng = np.random.default_rng(2)
    try:
        batch1 = rng.integers(0, 2**62, 300, dtype=np.uint64)
        svc.insert(batch1)
        assert started.wait(10.0)
        batch2 = rng.integers(0, 2**62, 40, dtype=np.uint64)
        svc.insert(batch2)               # lands mid-merge: the residual
        svc.delete(keys[1:4].copy())
        assert len(svc._op_journal) >= 1
        assert wait_for(lambda: svc.stats.merges == 1)
        logical = np.sort(np.concatenate(
            [np.delete(keys, [1, 2, 3]), batch1, batch2]))
        q = logical[::41]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))
        assert svc.n_keys == logical.size
        assert svc.n_pending > 0            # the replayed residual
    finally:
        svc.close()


def test_build_failure_contained_without_killing_worker(monkeypatch):
    """A failing rebuild is a contained ``MergeFailedError`` inside the
    worker loop: backoff armed, the live state serving, the worker alive,
    and the retry after the backoff succeeds."""
    keys = _keys()
    orig = Snapshot.build.__func__
    fails = [1]

    def failing_build(cls, *a, **kw):
        if kw.get("epoch", 0) > 0 and fails[0]:
            fails[0] -= 1
            raise OSError("injected build failure")
        return orig(cls, *a, **kw)
    monkeypatch.setattr(Snapshot, "build", classmethod(failing_build))
    svc = _svc(keys, merge_backoff_s=0.01, merge_backoff_cap_s=0.02)
    rng = np.random.default_rng(4)
    try:
        ins = rng.integers(0, 2**62, 300, dtype=np.uint64)
        svc.insert(ins)
        assert wait_for(lambda: svc.stats.merge_failures == 1)
        assert _worker_alive(svc)
        assert svc.stats.merges == 0 and svc.n_pending == ins.size
        logical = np.sort(np.concatenate([keys, ins]))
        q = logical[::53]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))
        time.sleep(0.05)                 # let the backoff expire
        svc.insert(rng.integers(0, 2**62, 5, dtype=np.uint64))
        assert wait_for(lambda: svc.stats.merges == 1)
    finally:
        svc.close()


def test_worker_death_contained_and_recovers():
    """The worker dies (an exception outside the contained rebuild): the
    live state is untouched and keeps serving merged lookups, and the next
    update after the backoff starts a fresh worker that merges."""
    keys = _keys()
    svc = _svc(keys, merge_backoff_s=0.01, merge_backoff_cap_s=0.02)
    rng = np.random.default_rng(3)
    real = svc._merge_once

    def dies_once():
        svc._merge_once = real
        raise RuntimeError("injected worker death")
    svc._merge_once = dies_once
    try:
        ins = rng.integers(0, 2**62, 300, dtype=np.uint64)
        svc.insert(ins)
        assert wait_for(lambda: svc.stats.merge_failures == 1)
        assert wait_for(lambda: not _worker_alive(svc))
        assert svc.stats.merges == 0 and svc.n_pending == ins.size
        logical = np.sort(np.concatenate([keys, ins]))
        q = logical[::53]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))
        time.sleep(0.05)
        more = rng.integers(0, 2**62, 10, dtype=np.uint64)
        svc.insert(more)                 # starts a fresh worker
        assert wait_for(lambda: svc.stats.merges == 1)
        logical = np.sort(np.concatenate([logical, more]))
        q = logical[::59]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))
    finally:
        svc.close()


def test_explicit_merge_failure_raises_and_keeps_state(monkeypatch):
    keys = _keys(20_000)
    svc = _svc(keys, merge_threshold=0)
    ins = np.random.default_rng(5).integers(0, 2**62, 50, dtype=np.uint64)
    svc.insert(ins)

    def broken(cls, *a, **kw):
        raise OSError("injected")
    monkeypatch.setattr(Snapshot, "build", classmethod(broken))
    with pytest.raises(MergeFailedError, match="untouched"):
        svc.merge()
    assert svc.stats.merge_failures == 1 and svc.n_pending == ins.size
    logical = np.sort(np.concatenate([keys, ins]))
    assert np.array_equal(svc.lookup(logical[::31]),
                          np.searchsorted(logical, logical[::31], "left"))
    svc.close()


def test_reader_writer_stress_exact_lookups():
    """Readers hammer lookup() while a writer pushes the service through
    several background merges; every answer stays in range, and the final
    state is exact."""
    keys = _keys(40_000)
    svc = _svc(keys, merge_threshold=128)
    rng = np.random.default_rng(6)
    stop = threading.Event()
    errors: list[BaseException] = []

    def reader():
        try:
            q = keys[:: max(1, keys.size // 128)].copy()
            while not stop.is_set():
                out = svc.lookup(q)
                assert np.all(out >= 0) and np.all(out < svc.n_keys + 1)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    expect = [keys]
    try:
        for _ in range(8):
            b = rng.integers(0, 2**62, 100, dtype=np.uint64)
            svc.insert(b)
            expect.append(b)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    svc.merge()                           # fold any residual
    logical = np.sort(np.concatenate(expect))
    q = logical[::71]
    assert np.array_equal(svc.lookup(q), np.searchsorted(logical, q, "left"))
    assert svc.n_keys == logical.size
    svc.close()


def test_explicit_merge_in_background_mode():
    keys = _keys(20_000)
    with _svc(keys, merge_threshold=0) as svc:
        ins = np.random.default_rng(8).integers(0, 2**62, 50,
                                                dtype=np.uint64)
        svc.insert(ins)
        assert svc.stats.merges == 0
        assert svc.merge() is True
        assert svc.n_pending == 0
        assert svc.merge() is False
        logical = np.sort(np.concatenate([keys, ins]))
        q = logical[::29]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))


def test_close_joins_worker(monkeypatch):
    """close() lets an in-flight merge finish and joins the worker."""
    keys = _keys(20_000)
    started = _slow_merges(monkeypatch, 0.3)
    svc = _svc(keys)
    svc.insert(np.random.default_rng(9).integers(0, 2**62, 300,
                                                 dtype=np.uint64))
    assert started.wait(10.0)
    svc.close()
    assert not _worker_alive(svc)
    assert svc.stats.merges == 1
    svc.close()                           # idempotent


def test_background_merges_match_reference_service():
    """The same rounds of inserts and deletes through the port and the
    reference, both merging in the background at the same threshold: after
    each round settles, equal logical keys and equal lookups."""
    keys = _keys(30_000, seed=12)
    kw = dict(n_shards=2, block=512, merge_mode="background",
              merge_threshold=200)
    port = PlexService(keys.copy(), 32, device="cpu", cache_slots=1 << 12,
                       **kw)
    ref = RService(keys.copy(), 32, backend="jnp", cache_slots=1 << 12, **kw)
    rng = np.random.default_rng(13)
    try:
        for r in range(3):
            ins = rng.integers(0, 2**62, 150, dtype=np.uint64)
            logical = port.logical_keys()
            dels = logical[rng.integers(0, logical.size, 60)]
            for svc in (port, ref):
                svc.insert(ins)
                svc.delete(dels)
            for svc in (port, ref):
                assert wait_for(lambda: svc.stats.merges >= r + 1
                                and svc.n_pending < 200)
                svc.drain()
            logical = port.logical_keys()
            assert np.array_equal(logical, ref.logical_keys())
            q = np.concatenate([logical[rng.integers(0, logical.size, 800)],
                                ins[:50], dels[:50]])
            got = port.lookup(q)
            assert np.array_equal(got, ref.lookup(q))
            assert np.array_equal(got, np.searchsorted(logical, q, "left"))
    finally:
        port.close()
        ref.close()


def test_delta_capture_and_pending_ops_match_reference():
    """The delta buffer's merge-side half against the reference's: counts,
    entries, replayable ops, and a captured state that later mutations do
    not change."""
    from repro.serving.delta import DeltaBuffer as RDelta
    from repro_torch.serving.delta import DeltaBuffer as TDelta
    rng = np.random.default_rng(14)
    keys = np.sort(rng.integers(0, 1 << 40, 5_000, dtype=np.uint64))
    keys[10:30] = keys[10]                        # a duplicate run
    ref, port = RDelta(keys), TDelta(keys)
    ins = rng.integers(0, 1 << 40, 100, dtype=np.uint64)
    for b in (ref, port):
        b.insert(ins)
    for b in (ref, port):
        b.delete(keys[[10, 7, 4_000]])
        b.insert(keys[[10]])
    assert (port.n_inserts, port.n_tombstones, port.net_keys) == \
        (ref.n_inserts, ref.n_tombstones, ref.net_keys) == (101, 3, 101 - 22)
    for a, b in zip(port.entries(), ref.entries()):
        assert np.array_equal(a, b)
    ops = port.pending_ops()
    assert [n for n, _ in ops] == [n for n, _ in ref.pending_ops()] == \
        ["delete", "insert"]
    replayed = TDelta(keys)
    for name, k in ops:
        getattr(replayed, name)(k)
    assert np.array_equal(replayed.logical_keys(), port.logical_keys())
    cut = port.capture()
    before = port.logical_keys()
    port.insert(np.asarray([1, 2, 3], np.uint64))
    assert np.array_equal(port.logical_keys(cut), before)
    assert port.logical_keys().size == before.size + 3
