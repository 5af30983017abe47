"""K1's hot-key cache in the port, held against the reference's.

The slot hash against ``jnp_lookup._cache_slot``; cached lookups through the
plain version against uncached ones, against the reference's
``_stacked_cached`` over the same planes and against ``np.searchsorted``
over {radix, CHT} x {probe count, bisect} x {no delta, live delta}; hit
counts against ``StackedJnpPlex`` where no two distinct keys of a
micro-batch share a slot; the service's per-epoch cache statistics against
the reference's ``PlexService(backend="jnp")`` through the full-hit path,
updates and a merge; the power-of-two check. The card's half (every lane of
a warm pass hits; the tear stress) is marked ``gpu``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import Snapshot as RSnap
from repro.data import generate
from repro.kernels import jnp_lookup as RJ
from repro.kernels import planes as RP
from repro.kernels.pairs import split_u64
from repro.obs.metrics import METRICS as RMETRICS
from repro.serving import PlexService as RService
from repro_torch.core.index import Snapshot
from repro_torch.kernels import planes as TP
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.keys import to_biased
from repro_torch.obs.metrics import METRICS
from repro_torch.serving import PlexService

from test_torch_planes import _port_plex
from test_torch_stacked_lookup import _delta, _forced, _queries, _wrapped, \
    keys, offs  # noqa: F401  (module fixtures)

U64_MAX = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _reset_registries():
    yield
    for m in (METRICS, RMETRICS):
        m.reset()
        m.disable()
        m.counted_dispatch = True


def _tq(q: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(to_biased(np.asarray(q, np.uint64)))


def _unique_keys(rng, n):
    return np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))


@pytest.mark.parametrize("n_slots", [1, 1 << 12, 1 << 20, 1 << 31])
def test_cache_slot_matches_reference(n_slots):
    rng = np.random.default_rng(1)
    q = np.concatenate([
        np.asarray([0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
                    U64_MAX - 1, U64_MAX], np.uint64),
        rng.integers(0, U64_MAX, 20_000, dtype=np.uint64, endpoint=True)])
    qh, ql = split_u64(q)
    want = np.asarray(RJ._cache_slot(jnp.asarray(qh), jnp.asarray(ql),
                                     n_slots)).astype(np.int64)
    assert np.array_equal(SL.cache_slot(_tq(q), n_slots).numpy(), want)


def _reference_cached(sp, probe, dp):
    """The reference's cached dispatch over ``sp``: a function of one
    micro-batch and the cache, giving (ranks, new cache)."""
    fn = jax.jit(functools.partial(
        RJ._stacked_cached, functools.partial(RJ._stacked_pipeline, sp,
                                              probe),
        0 if dp is None else dp.cap))
    delta = () if dp is None else (dp.khi, dp.klo, dp.cum0)

    def run(q, cache):
        qh, ql = split_u64(q)
        res, cache, _, _ = fn(jnp.asarray(qh), jnp.asarray(ql),
                              np.int32(q.size), cache, *delta)
        return np.asarray(res).astype(np.int64), cache
    return run


@pytest.mark.parametrize("fold", [False, True], ids=["cap0", "delta"])
@pytest.mark.parametrize("probe", ["count", "bisect"])
@pytest.mark.parametrize("kind", ["radix", "cht"])
def test_cached_lookup_matches_uncached_reference_and_searchsorted(
        kind, probe, fold, keys, offs):
    """Micro-batches of 512 through a 16,384-slot cache, repeats included
    (so later batches hit): every rank equals the uncached plain version's,
    the reference's cached ranks (R5's wrapped keys: searchsorted) and, for
    present keys, searchsorted over the logical keys."""
    rng = np.random.default_rng(12)
    pxs = _forced(keys, offs, kind)
    sp = RP.build_stacked_planes(pxs, offs)
    tsp = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    rdp = tdp = None
    extra = ()
    logical = keys
    if fold:
        rdp, tdp, extra, logical = _delta(keys, rng)
    q0 = _queries(keys, offs, rng, extra)
    q = np.concatenate([q0, q0[rng.integers(0, q0.size, q0.size)]])
    slots = 1 << 14
    cache = torch.full((2 * slots,), -1, dtype=torch.int64)
    rcache = jnp.full((3, slots), RJ._CACHE_EMPTY, jnp.uint32)
    reference = _reference_cached(sp, probe, rdp)
    hits_total = 0
    for i in range(0, q.size, 512):
        qb = q[i:i + 512]
        hits = torch.zeros(1, dtype=torch.int32)
        got = SL.stacked_lookup(tsp, probe, _tq(qb), tdp, cache=cache,
                                hits=hits)[0].numpy().astype(np.int64)
        plain = SL.stacked_lookup(tsp, probe, _tq(qb), tdp)[0].numpy()
        assert np.array_equal(got, plain)
        want, rcache = reference(qb, rcache)
        wrap = _wrapped(tsp, qb)
        assert np.array_equal(got[~wrap], want[~wrap])
        assert np.array_equal(got[wrap],
                              np.searchsorted(logical, qb[wrap], "left"))
        present = np.isin(qb, logical)
        assert np.array_equal(got[present],
                              np.searchsorted(logical, qb[present], "left"))
        hits_total += int(hits)
    assert hits_total > q.size // 4


def _distinct_slot_keys(keys, n_slots, n):
    """``n`` keys of ``keys`` whose cache slots are pairwise distinct."""
    slot = SL.cache_slot(_tq(keys), n_slots).numpy()
    _, first = np.unique(slot, return_index=True)
    return keys[np.sort(first)[:n]]


@pytest.mark.parametrize("fold", [False, True], ids=["cap0", "delta"])
def test_hit_counts_equal_reference_on_distinct_slot_traffic(fold):
    """Where no two distinct keys of a micro-batch share a slot, each
    launch's hit count and full-hit flag equal the reference's, the last
    (short) micro-batch included."""
    rng = np.random.default_rng(3)
    keys = generate("amzn", 30_000, 0)
    slots = 1 << 12
    port = Snapshot.build(keys.copy(), 32, n_shards=3, device="cpu")
    ref = RSnap.build(keys.copy(), 32, n_shards=3)
    st = port.stacked_impl(block=512, probe="bisect", cache_slots=slots)
    rj = RJ.StackedJnpPlex.from_plexes(
        [s.plex for s in ref.shards], ref.offsets, block=512, probe="bisect",
        cache_slots=slots)
    assert st is not None and rj is not None
    tdp = rdp = None
    if fold:
        from repro.serving.delta import DeltaBuffer as RDelta
        from repro_torch.serving.delta import DeltaBuffer as TDelta
        ins = rng.integers(keys[0], keys[-1], 200, dtype=np.uint64)
        rb, tb = RDelta(keys, capacity=512), TDelta(keys, capacity=512)
        for b in (rb, tb):
            b.insert(ins)
            b.delete(keys[:50])
        rdp, tdp = rb.device_view(), tb.device_view("cpu")
    hot = _distinct_slot_keys(keys, slots, 300)
    sizes = [512, 512, 512, 300, 512, 100]
    n_full = 0
    for n in sizes:
        q = hot[rng.integers(0, hot.size, n)]
        got = st.lookup_planes(_tq(q), delta=tdp)
        qp = np.concatenate([q, np.repeat(q[-1:], 512 - n)])
        qh, ql = split_u64(qp)
        want = rj.lookup_planes(jnp.asarray(qh), jnp.asarray(ql),
                                n_valid=n, delta=rdp)
        assert np.array_equal(got.out.numpy(),
                              np.asarray(want.out)[:n])
        assert int(got.hits) == int(want.hits)
        assert got.full_hit == bool(want.full_hit)
        n_full += got.full_hit
    assert 0 < n_full < len(sizes)


def _services(keys, **kw):
    return (PlexService(keys.copy(), device="cpu", **kw),
            RService(keys.copy(), backend="jnp", **kw))


def _stats(svc):
    s = svc.stats
    return (s.cache_queries, s.cache_hits, s.full_hit_batches, s.epoch)


def test_epoch_stats_reset_on_swap():
    rng = np.random.default_rng(0)
    keys = _unique_keys(rng, 20_000)
    port, ref = _services(keys, eps=16, n_shards=2, block=512,
                          cache_slots=1 << 12, merge_threshold=256)
    hot = keys[rng.integers(0, 32, 2_048)]
    for svc in (port, ref):
        svc.lookup(hot)
        svc.lookup(hot)
    assert _stats(port) == _stats(ref)
    assert port.stats.cache_hits > 0
    assert 0.0 < port.stats.cache_hit_rate <= 1.0
    ins = rng.integers(0, 1 << 62, 300, dtype=np.uint64)
    for svc in (port, ref):
        svc.insert(ins)                            # merges
    assert port.stats.merges == 1 and port.stats.epoch == port.epoch == 1
    assert (port.stats.cache_queries, port.stats.cache_hits,
            port.stats.cache_hit_rate) == (0, 0, 0.0)
    for svc in (port, ref):
        assert np.array_equal(svc.lookup(hot), np.searchsorted(
            svc.logical_keys(), hot, "left"))
    assert port.stats.cache_queries == hot.size
    assert _stats(port) == _stats(ref)


def test_launch_on_a_replaced_state_is_not_credited_to_the_new_epoch():
    """A lookup that captured its state before a publish runs against the
    old snapshot: its hits belong to the old epoch and are dropped, not
    counted in the new one."""
    rng = np.random.default_rng(3)
    keys = _unique_keys(rng, 20_000)
    svc = PlexService(keys, 16, n_shards=2, block=512, cache_slots=1 << 12,
                      merge_threshold=0, device="cpu")
    hot = keys[rng.integers(0, 32, 2_048)]
    svc.lookup(hot)
    old = svc._state
    svc.insert(rng.integers(0, 1 << 62, 300, dtype=np.uint64))
    assert svc.merge() and svc.stats.epoch == 1
    got = svc._stacked_lookup(old, hot)
    assert np.array_equal(got, np.searchsorted(keys, hot, "left"))
    assert (svc.stats.cache_queries, svc.stats.cache_hits) == (0, 0)
    svc.lookup(hot)
    assert svc.stats.cache_queries == hot.size


def test_cache_accounting_counts_only_real_lanes():
    """The reference pads a short micro-batch and masks the pad; the port
    launches only the real lanes: the same counts, and no padded lane."""
    rng = np.random.default_rng(1)
    keys = _unique_keys(rng, 10_000)
    port, ref = _services(keys, eps=16, block=512, cache_slots=1 << 12)
    q = keys[rng.integers(0, keys.size, 100)]
    for svc in (port, ref):
        svc.lookup(q)
        svc.lookup(q)
    assert port.stats.cache_queries == 200
    assert _stats(port) == _stats(ref)
    assert port.stats.padded_lanes == 0 < ref.stats.padded_lanes


def test_full_hit_path_survives_updates():
    """A micro-batch whose lanes all hit counts as a full hit, stays
    exact, and still full-hits after an update: entries are
    delta-independent snapshot ranks and the delta folds in after them."""
    rng = np.random.default_rng(2)
    keys = _unique_keys(rng, 10_000)
    port, ref = _services(keys, eps=16, block=512, cache_slots=1 << 13)
    q = keys[rng.integers(0, 8, 512)]
    want = np.searchsorted(keys, q, "left")
    for svc in (port, ref):
        assert np.array_equal(svc.lookup(q), want)     # cold fill
    assert port.stats.full_hit_batches == 0
    for svc in (port, ref):
        assert np.array_equal(svc.lookup(q), want)     # every lane hits
    assert port.stats.full_hit_batches == 1
    low = np.asarray([q.min() - 1], np.uint64)
    for svc in (port, ref):
        svc.insert(low)
        svc.delete(q[:1])
    logical = port.logical_keys()
    assert np.array_equal(logical, ref.logical_keys())
    for svc in (port, ref):
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(logical, q, "left"))
    assert port.stats.full_hit_batches == 2
    assert _stats(port) == _stats(ref)


def test_cache_on_and_off_give_the_same_answers():
    rng = np.random.default_rng(4)
    keys = generate("amzn", 30_000, 0)
    on = PlexService(keys.copy(), eps=16, n_shards=2, block=512,
                     cache_slots=1 << 13, device="cpu")
    off = PlexService(keys.copy(), eps=16, n_shards=2, block=512,
                      device="cpu")
    assert on.fused and on.snapshot.stacked_impl(
        block=512, cache_slots=1 << 13) is on._state.stacked
    hot = keys[rng.integers(0, 64, 10_000)]
    want = np.searchsorted(keys, hot, "left")
    assert np.array_equal(on.lookup(hot), want)
    assert np.array_equal(on.lookup(hot), want)
    assert on.stats.cache_hit_rate > 0.4
    assert np.array_equal(off.lookup(hot), want)
    assert off.stats.cache_queries == 0
    ins = rng.integers(keys[0], keys[-1], 500, dtype=np.uint64)
    for svc in (on, off):
        svc.insert(ins)
        svc.delete(hot[:20])
    logical = on.logical_keys()
    assert np.array_equal(on.lookup(hot), off.lookup(hot))
    assert np.array_equal(on.lookup(hot),
                          np.searchsorted(logical, hot, "left"))


def test_cache_slots_must_be_a_power_of_two():
    keys = generate("amzn", 5_000, 0)
    with pytest.raises(ValueError, match="power of two"):
        PlexService(keys, cache_slots=3, device="cpu")
    snap = Snapshot.build(keys, 16, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        snap.stacked_impl(cache_slots=6)
    with pytest.raises(ValueError, match="power of two"):
        SL.StackedTorchPlex.from_plexes(snap.shards, snap.offsets,
                                        device="cpu", cache_slots=5)
    st = snap.stacked_impl(cache_slots=8)
    assert st.cache_slots == 8 and st._cache.shape == (16,)
    q = _tq(keys[:4])
    with pytest.raises(ValueError, match="power of two"):
        SL.stacked_lookup(st.planes, st.probe, q,
                          cache=torch.full((12,), -1, dtype=torch.int64),
                          hits=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="hits"):
        SL.stacked_lookup(st.planes, st.probe, q, cache=st._cache)
    with pytest.raises(ValueError, match="neither"):
        SL.stacked_lookup(st.planes, st.probe, q, cache=st._cache,
                          hits=torch.zeros(1, dtype=torch.int32), aux=True)


# ---------------------------------------------------------------- card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_warm_pass_over_distinct_slots_hits_every_lane_on_card(cuda):
    keys = generate("amzn", 200_000, 0)
    snap = Snapshot.build(keys.copy(), 32, n_shards=2, device=cuda)
    slots = 1 << 16
    st = snap.stacked_impl(block=1 << 14, cache_slots=slots)
    hot = _distinct_slot_keys(keys, slots, 4_096)
    q = hot[np.random.default_rng(0).integers(0, hot.size, 1 << 16)]
    qd = _tq(q).to(cuda)
    st.dispatch(qd)                                    # cold fill
    warm = st.dispatch(qd)
    assert all(r.full_hit for r in warm)
    got = torch.cat([r.out for r in warm]).cpu().numpy()
    assert np.array_equal(got, np.searchsorted(keys, q, "left"))


@pytest.mark.gpu
def test_tear_stress_on_card(cuda):
    """2^20 lanes over 64 distinct keys that share one slot, 20 launches:
    no slot is ever read torn (every rank equals searchsorted)."""
    from test_torch_service import _load_smoke
    keys = generate("amzn", 200_000, 0)
    snap = Snapshot.build(keys.copy(), 32, device=cuda)
    st = snap.stacked_impl(block=1 << 20, cache_slots=1 << 20)
    same = _load_smoke().same_slot_keys(keys, 1 << 20, 64, 0)
    q = same[np.random.default_rng(1).integers(0, 64, 1 << 20)]
    want = torch.from_numpy(np.searchsorted(keys, q, "left")).to(cuda)
    qd = _tq(q).to(cuda)
    for _ in range(20):
        assert torch.equal(st.dispatch(qd)[0].out.long(), want)
