"""The port's distribution layer against the reference's: one counterpart
for each of ``tests/test_distrib.py``'s tests (placement, per-slot
partitioned planes, the routed lookup, the service's ``plan=`` path and
partial loads), the device-loss tests of ``tests/test_resilience.py``, then
checks of what only the port has (slot streams, the counted fold per slot)
and, on a CUDA card, the router through K1.

Both packages run on the same seeded keys. The reference serves through
``backend="jnp"`` on JAX's one CPU device, repeated as its own tests repeat
it for a router of several devices; the port serves with ``device="cpu"``,
``backend="torch"`` (the plain pipeline) and ``[cpu] * N`` slots. The
reference's service checks its plan against its mesh of physical devices,
so a planned reference service runs with ``plan=1`` and plans of more
devices are compared through ``repro.distrib`` directly. Plans compare
field for field and ranks exactly; past-the-end keys follow R5 (the port
saturates, so they are held to searchsorted, where the reference's wrap
may differ). Generations written by either package are planned and opened
by the other.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.distrib as RD
from repro.core import LearnedIndex as RIndex
from repro.core import Snapshot as RSnap
from repro.persist import load_snapshot as r_load_snapshot
from repro.persist import save_snapshot as r_save_snapshot
from repro.resilience import FAULTS as RFAULTS
from repro.resilience import PartitionLoadError as RPartitionLoadError
from repro.resilience import fail_once as r_fail_once
from repro.serving import PlexService as RService
from repro.serving.delta import DeltaBuffer as RDelta
from repro_torch.core import Snapshot
from repro_torch.core.cht import build_cht
from repro_torch.core.plex import build_plex
from repro_torch.distrib import (RoutedStackedLookup, open_routed,
                                 partition_contiguous, partition_stacked,
                                 plan_from_dir, plan_placement,
                                 shard_hotness, shard_weights)
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.backends import BACKENDS
from repro_torch.obs import METRICS
from repro_torch.obs import incident as incident_mod
from repro_torch.persist import load_snapshot, save_snapshot
from repro_torch.resilience import FAULTS, PartitionLoadError, fail_n, \
    fail_once
from repro_torch.resilience.faults import POINT_PARTITION_LOAD
from repro_torch.serving import PlexService
from repro_torch.serving.delta import DeltaBuffer

from conftest import sorted_u64

BLOCK = 512
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
DISTRIB = ("distrib/__init__.py", "distrib/placement.py",
           "distrib/partition.py", "distrib/routed_lookup.py",
           "distrib/loader.py")


@pytest.fixture(autouse=True)
def _clean():
    """No armed fault, metric or incident manager leaks between tests."""
    def reset():
        FAULTS.reset()
        RFAULTS.reset()
        incident_mod.uninstall()
        METRICS.reset()
        METRICS.disable()
        METRICS.counted_dispatch = True
    reset()
    yield
    reset()


def _rdevices(n: int) -> list:
    """The reference's placement targets: its CPU device, repeated."""
    return [jax.devices()[0]] * n


def _pdevices(n: int) -> list:
    return [CPU] * n


def _plans_equal(a, b) -> None:
    """Field-for-field equality of a port plan and a reference plan."""
    assert a.n_devices == b.n_devices
    for f in ("shard_start", "key_start", "active", "bound_keys", "weights"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _snapshots(keys, eps=32, n_shards=4):
    """The reference's and the port's snapshot of the same keys (the two
    builds are identical)."""
    return (RSnap.build(keys.copy(), eps, n_shards=n_shards),
            Snapshot.build(keys.copy(), eps, n_shards=n_shards, device=CPU))


def _skewed_snapshots(rng, sizes, eps=32):
    """Both packages' snapshots with explicitly skewed shard sizes."""
    keys = sorted_u64(rng, int(sum(sizes)))
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    ends = list(offs[1:]) + [keys.size]
    rsnap = RSnap(keys, eps, offs, [RIndex.build(keys[o:e], eps)
                                    for o, e in zip(offs, ends)])
    psnap = Snapshot(keys, eps, offs, [build_plex(keys[o:e], eps)
                                       for o, e in zip(offs, ends)],
                     device=CPU)
    return rsnap, psnap, keys


def _routers(rsnap, psnap, n_dev, *, hotness=None):
    """Both packages' routers over ``n_dev`` slots, plans checked equal."""
    rplan = RD.plan_placement(rsnap, n_dev, hotness=hotness)
    pplan = plan_placement(psnap, n_dev, hotness=hotness)
    _plans_equal(pplan, rplan)
    rparts = RD.partition_stacked(rsnap, rplan, _rdevices(n_dev),
                                  block=BLOCK)
    pparts = partition_stacked(psnap, pplan, _pdevices(n_dev), block=BLOCK,
                               backend="torch")
    assert rparts is not None and pparts is not None
    return (RD.RoutedStackedLookup(rplan, rparts, BLOCK),
            RoutedStackedLookup(pplan, pparts, BLOCK))


def _hold(port, ref, q, logical):
    """The port equals searchsorted everywhere, and the reference wherever
    a key is not past the end (R5)."""
    assert np.array_equal(port, np.searchsorted(logical, q, "left"))
    assert np.all((port == ref) | (q > logical[-1]))


def _queries(rng, keys, n_present=3_000, n_absent=3_000):
    return np.concatenate([
        keys[rng.integers(0, keys.size, n_present)],
        rng.integers(0, 1 << 62, n_absent, dtype=np.uint64),
        np.asarray([0, keys[0], keys[-1], ~np.uint64(0)], np.uint64)])


# ------------------------------------------------------------ placement ----

@pytest.mark.parametrize("weights,n_parts", [
    ([5., 1, 1, 1, 1, 5], 3), ([3., 2], 4), ([1., 2, 3, 4, 5, 6, 7], 3),
    ([0., 0, 7, 0], 2)])
def test_partition_contiguous_optimal_and_surplus(weights, n_parts):
    w = np.asarray(weights)
    b = partition_contiguous(w, n_parts)
    assert np.array_equal(b, RD.partition_contiguous(w, n_parts))
    if weights == [5., 1, 1, 1, 1, 5]:
        assert max(w[b[i]:b[i + 1]].sum() for i in range(3)) == 5
    if weights == [3., 2]:
        assert list(b) == [0, 1, 2, 2, 2]
    with pytest.raises(ValueError):
        partition_contiguous(np.asarray([]), 2)
    with pytest.raises(ValueError):
        partition_contiguous(np.asarray([-1.0]), 2)


def test_plan_skewed_shards_balance(rng):
    """One giant shard must not drag its neighbours onto the same slot."""
    rsnap, psnap, _ = _skewed_snapshots(
        rng, [40_000, 2_000, 2_000, 2_000, 2_000])
    plan = plan_placement(psnap, 2)
    _plans_equal(plan, RD.plan_placement(rsnap, 2))
    w = shard_weights(psnap)
    assert np.array_equal(w, RD.shard_weights(rsnap))
    assert plan.shard_range(0) == (0, 1)
    assert plan.shard_range(1) == (1, 5)
    assert plan.weights[0] == pytest.approx(w[0])
    q = sorted_u64(rng, 3_000)
    sid = psnap.route(q)
    shard_dev = np.searchsorted(plan.shard_start[1:-1], sid, side="right")
    assert np.array_equal(plan.device_of(q), shard_dev)
    assert np.array_equal(plan.device_of(q),
                          RD.plan_placement(rsnap, 2).device_of(q))


def test_plan_more_devices_than_shards(rng):
    rsnap, psnap, keys = _skewed_snapshots(rng, [5_000, 5_000, 5_000])
    plan = plan_placement(psnap, 8)
    _plans_equal(plan, RD.plan_placement(rsnap, 8))
    assert plan.n_devices == 8 and plan.n_active == 3
    for d in range(plan.n_devices):
        lo, hi = plan.shard_range(d)
        assert (hi > lo) == (d in plan.active)
    q = np.concatenate([keys, np.asarray([0, ~np.uint64(0)], np.uint64)])
    assert np.isin(plan.device_of(q), plan.active).all()
    assert plan.describe() == RD.plan_placement(rsnap, 8).describe()


def test_plan_hotness_skews_placement(rng):
    """A hot shard earns its own slot even when key counts are even."""
    rsnap, psnap, _ = _skewed_snapshots(rng, [8_000] * 4)
    hot = np.asarray([100.0, 1.0, 1.0, 1.0])
    plan = plan_placement(psnap, 2, hotness=hot)
    _plans_equal(plan, RD.plan_placement(rsnap, 2, hotness=hot))
    assert plan.shard_range(0) == (0, 1)
    sample = psnap.keys[rng.integers(0, 8_000, 5_000)]
    h = shard_hotness(psnap, sample)
    assert np.array_equal(h, RD.shard_hotness(rsnap, sample))
    assert h.argmax() == 0 and h[0] == 5_000


def test_plan_single_device_is_trivial(rng):
    rsnap, psnap, keys = _skewed_snapshots(rng, [6_000, 6_000])
    plan = plan_placement(psnap, 1)
    _plans_equal(plan, RD.plan_placement(rsnap, 1))
    assert plan.shard_range(0) == (0, 2)
    assert plan.key_range(0) == (0, keys.size)
    assert np.array_equal(plan.device_of(keys[:100]), np.zeros(100))
    with pytest.raises(ValueError):
        plan_placement(psnap, 0)


def test_plan_row_slice_byte_math(rng):
    rsnap, psnap, _ = _skewed_snapshots(rng, [4_000, 4_000, 4_000])
    plan = plan_placement(psnap, 3)
    rplan = RD.plan_placement(rsnap, 3)
    for d in range(3):
        assert plan.row_slice(d, 1024) == rplan.row_slice(d, 1024)
    assert plan.row_slice(1, 1024) == slice(1024, 2048)


# ------------------------------------------- partition + routed lookup ----

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_routed_parity_present_and_absent(n_dev, rng):
    """Routed ranks equal the reference's routed ranks and searchsorted for
    any plan width, present and absent keys."""
    keys = np.unique(sorted_u64(rng, 60_000))
    rsnap, psnap = _snapshots(keys, n_shards=6)
    rrouter, router = _routers(rsnap, psnap, n_dev)
    q = _queries(rng, keys)
    out, batch = router.lookup(q)
    rout, rbatch = rrouter.lookup(q)
    _hold(out, rout, q, keys)
    assert batch.n_batches == rbatch.n_batches >= router.n_active
    assert batch.padded_lanes == 0


def test_routed_merged_delta_parity(rng):
    """The per-slot merged fold (replicated delta planes) equals the
    reference's and searchsorted over the logical key array."""
    keys = np.unique(sorted_u64(rng, 40_000))
    rsnap, psnap = _snapshots(keys)
    rrouter, router = _routers(rsnap, psnap, 4)
    ins = rng.integers(0, 1 << 62, 300, dtype=np.uint64)
    dels = np.unique(keys[rng.integers(0, keys.size, 200)])
    rdelta, delta = RDelta(rsnap.keys), DeltaBuffer(psnap.keys)
    for buf in (rdelta, delta):
        buf.insert(ins)
        buf.delete(dels)
    logical = delta.logical_keys()
    assert np.array_equal(logical, rdelta.logical_keys())
    q = np.concatenate([logical[rng.integers(0, logical.size, 3_000)],
                        rng.integers(0, 1 << 62, 1_000, dtype=np.uint64)])
    view = delta.device_view(CPU)
    out, _ = router.lookup(q, view)
    _hold(out, rrouter.lookup(q, rdelta.device_view())[0], q, logical)
    # the replica table is cached per view: a second lookup copies nothing
    reps = router._delta_cache
    router.lookup(q, view)
    assert router._delta_cache is reps and set(reps[1]) == \
        {int(d) for d in router.plan.active}
    out2, _ = router.lookup(q)
    assert np.array_equal(out2, np.searchsorted(keys, q, "left"))


def test_zero_collectives_in_compiled_dispatch(rng):
    """No traffic between slots inside a dispatch: the reference's compiled
    dispatches hold no collective, and the port's distrib modules import no
    ``torch.distributed``, every tensor handed to a slot's impl lives on
    that slot's device, and each slot receives only the queries routed to
    it, with the delta replica of its own table entry."""
    from repro.kernels.pairs import split_u64
    from repro.kernels.planes import build_delta_planes, move_delta_planes
    keys = np.unique(sorted_u64(rng, 30_000))
    rsnap, psnap = _snapshots(keys)
    rrouter, router = _routers(rsnap, psnap, 2)
    dummy = build_delta_planes(keys[:1], np.ones(1, np.int64), 128)
    for d in rrouter.plan.active:
        part = rrouter.parts[d]
        qh, ql = split_u64(np.repeat(keys[:1], BLOCK))
        qhi = jax.device_put(qh, part.sharding)
        qlo = jax.device_put(ql, part.sharding)
        dp = move_delta_planes(dummy, part.sharding)
        for fn, args in ((part.impl._fn, (qhi, qlo)),
                         (part.impl._merged_fn(dp.cap),
                          (qhi, qlo, dp.khi, dp.klo, dp.cum0))):
            hlo = fn.lower(*args).compile().as_text()
            for coll in ("all-reduce", "all-gather", "all-to-all",
                         "collective-permute", "reduce-scatter"):
                assert coll not in hlo, (d, coll)
    for rel in DISTRIB:
        names = _imported_names(ROOT / "src" / "repro_torch" / rel)
        assert not any(n.startswith("torch.distributed") for n in names)
    seen = {}
    for d in router.plan.active:
        part = router.parts[d]
        orig = part.impl.lookup_planes

        def spy(qd, *a, _d=int(d), _part=part, _o=orig, **kw):
            dp = kw.get("delta")
            devs = {qd.device} | ({dp.keys.device, dp.cum0.device}
                                  if dp is not None else set())
            assert devs == {_part.device}
            seen.setdefault(_d, []).append((qd.clone(), dp))
            return _o(qd, *a, **kw)
        part.impl.lookup_planes = spy
    delta = DeltaBuffer(psnap.keys)
    delta.insert(keys[:1])
    q = keys[rng.integers(0, keys.size, 4_000)]
    out, _ = router.lookup(q, delta.device_view(CPU))
    assert np.array_equal(out, np.searchsorted(delta.logical_keys(), q))
    reps = router._delta_cache[1]
    for d, calls in seen.items():
        got = np.concatenate([c[0].numpy() for c in calls])
        want = np.sort((q[router.plan.device_of(q) == d]
                        ^ np.uint64(1 << 63)).view(np.int64))
        assert np.array_equal(np.sort(got), want)
        assert all(c[1] is reps[d] for c in calls)


def test_one_dispatch_per_microbatch_per_device(rng):
    """One launch per micro-batch per slot, as many as the reference's jit
    dispatches per device."""
    keys = np.unique(sorted_u64(rng, 40_000))
    rsnap, psnap = _snapshots(keys)
    rrouter, router = _routers(rsnap, psnap, 2)
    rcalls, calls = {}, {}
    for d in rrouter.plan.active:
        impl = rrouter.parts[d].impl
        impl._fn = (lambda *a, _d=int(d), _o=impl._fn:
                    (rcalls.setdefault(_d, []).append(1), _o(*a))[1])
        pimpl = router.parts[d].impl
        pimpl.lookup_planes = (
            lambda *a, _d=int(d), _o=pimpl.lookup_planes, **kw:
            (calls.setdefault(_d, []).append(1), _o(*a, **kw))[1])
    q = keys[rng.integers(0, keys.size, 3 * BLOCK + 100)]
    out, batch = router.lookup(q)
    rout, rbatch = rrouter.lookup(q)
    _hold(out, rout, q, keys)
    dev = router.plan.device_of(q)
    want = {int(d): -(-int(np.sum(dev == d)) // BLOCK)
            for d in router.plan.active if np.any(dev == d)}
    assert {d: len(v) for d, v in calls.items()} == want
    assert {d: len(v) for d, v in rcalls.items()} == want
    assert batch.n_batches == rbatch.n_batches == sum(want.values())
    assert [len(lanes) for _, _, lanes, _, _ in batch.spans] == \
        [want[d] for d in sorted(want)]


@pytest.mark.parametrize("n_shards,n_dev", [(6, 4), (48, 40), (3, 8)])
def test_slot_binning_equals_device_of(n_shards, n_dev, rng):
    """The router's binning (``torch.bucketize`` over the biased slot
    boundaries) gives ``PlacementPlan.device_of``'s slot for every query,
    below the first key, on a boundary and past the last included."""
    from repro_torch.distrib.routed_lookup import slot_bounds, \
        slot_positions
    from repro_torch.kernels.keys import to_biased
    keys = np.unique(sorted_u64(rng, 30_000))
    plan = plan_placement(Snapshot.build(keys.copy(), 32, n_shards=n_shards,
                                         device=CPU), n_dev)
    q = np.concatenate([_queries(rng, keys), plan.bound_keys,
                        plan.bound_keys - np.uint64(1)])
    pos = slot_positions(torch.from_numpy(to_biased(q)), slot_bounds(plan))
    assert np.array_equal(plan.active[pos.numpy()], plan.device_of(q))


def test_partition_unification_is_per_device(rng):
    """Shards that cannot unify as a whole may still partition into per-slot
    unifiable slabs; a plan that splits the conflict serves."""
    from repro.core.cht import build_cht as r_build_cht
    from repro.core.plex import build_plex as r_build_plex
    keys = sorted_u64(rng, 20_000)
    offs = np.asarray([0, 10_000], dtype=np.int64)
    rplex = [r_build_plex(keys[:10_000], 32), r_build_plex(keys[10_000:], 32)]
    pplex = [build_plex(keys[:10_000], 32), build_plex(keys[10_000:], 32)]
    # force one CHT shard: mixed kinds fail the global unification gate
    rplex[1] = dataclasses.replace(
        rplex[1], layer=r_build_cht(rplex[1].spline.keys, 4, 16))
    pplex[1] = dataclasses.replace(
        pplex[1], layer=build_cht(pplex[1].spline.keys, 4, 16))
    rsnap = RSnap(keys, 32, offs, [RIndex(plex=p) for p in rplex])
    psnap = Snapshot(keys, 32, offs, pplex, device=CPU)
    assert rsnap.stacked_impl(block=BLOCK) is None
    assert psnap.stacked_impl("torch", block=BLOCK) is None
    # a one-slot plan holds the conflict: no partition
    assert partition_stacked(psnap, plan_placement(psnap, 1), _pdevices(1),
                             block=BLOCK, backend="torch") is None
    rrouter, router = _routers(rsnap, psnap, 2)
    assert [p.impl.planes.kind for p in router.parts] == ["radix", "cht"]
    q = keys[rng.integers(0, keys.size, 2_000)]
    _hold(router.lookup(q)[0], rrouter.lookup(q)[0], q, keys)


# ------------------------------------------------- PlexService plan path ----

def _planned(keys, n_dev, **kw):
    kw.setdefault("n_shards", 4)
    return PlexService(keys.copy(), eps=32, block=BLOCK, device=CPU,
                       backend="torch", devices=_pdevices(n_dev), plan=n_dev,
                       **kw)


def _rplanned(keys, **kw):
    kw.setdefault("n_shards", 4)
    return RService(keys.copy(), eps=32, block=BLOCK, plan=1, **kw)


def test_service_plan_parity_all_backends(rng):
    """Empty-delta and live-delta lookups through a planned service equal
    the reference's and searchsorted on every backend."""
    keys = np.unique(sorted_u64(rng, 40_000))
    svc = _planned(keys, 4, merge_threshold=0)
    rsvc = _rplanned(keys, merge_threshold=0)
    assert svc.plan is not None and rsvc.plan is not None
    _plans_equal(svc.plan, RD.plan_placement(rsvc._state.snapshot, 4))
    q = np.concatenate([keys[rng.integers(0, keys.size, 2_000)],
                        rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    ref = rsvc.lookup(q, backend="jnp")
    for backend in BACKENDS:
        _hold(svc.lookup(q, backend=backend), ref, q, keys)
    ins = rng.integers(0, 1 << 62, 400, dtype=np.uint64)
    dels = np.unique(keys[rng.integers(0, keys.size, 300)])
    for s in (svc, rsvc):
        s.insert(ins)
        s.delete(dels)
    logical = svc.logical_keys()
    assert np.array_equal(logical, rsvc.logical_keys())
    ref = rsvc.lookup(q, backend="jnp")
    for backend in BACKENDS:
        _hold(svc.lookup(q, backend=backend), ref, q, logical)


def test_service_single_device_plan_bit_identical(rng):
    """A one-slot plan gives the unplanned service's ranks bit for bit,
    absent keys and duplicate runs included."""
    keys = sorted_u64(rng, 50_000, dups=True)
    planned = _planned(keys, 1)
    legacy = PlexService(keys.copy(), eps=32, n_shards=4, block=BLOCK,
                         device=CPU, backend="torch")
    assert planned.plan is not None and planned.plan.n_devices == 1
    assert legacy.plan is None and legacy.health()["routed_devices"] == 0
    q = np.concatenate([keys[rng.integers(0, keys.size, 4_000)],
                        rng.integers(0, 1 << 62, 4_000, dtype=np.uint64),
                        np.asarray([0, ~np.uint64(0)], np.uint64)])
    a = planned.lookup(q)
    assert np.array_equal(a, legacy.lookup(q))
    _hold(a, _rplanned(keys).lookup(q, backend="jnp"), q, keys)


def test_service_plan_more_devices_than_shards(rng):
    keys = np.unique(sorted_u64(rng, 20_000))
    svc = _planned(keys, 8, n_shards=2)
    assert svc.plan.n_devices == 8 and svc.plan.n_active <= 2
    _plans_equal(svc.plan, RD.plan_placement(
        RSnap.build(keys.copy(), 32, n_shards=2), 8))
    assert svc.health()["routed_devices"] == 8
    q = keys[rng.integers(0, keys.size, 2_000)]
    assert np.array_equal(svc.lookup(q), np.searchsorted(keys, q, "left"))


def test_service_merge_replans(rng):
    """A threshold merge rebuilds the snapshot and re-plans the slots; the
    swapped state serves the merged logical array through the new plan,
    the reference's plan of its own merged snapshot."""
    keys = np.unique(sorted_u64(rng, 30_000))
    svc = _planned(keys, 2, n_shards=3, merge_threshold=256)
    rsvc = _rplanned(keys, n_shards=3, merge_threshold=256)
    plan0 = svc.plan
    ins = rng.integers(0, 1 << 62, 300, dtype=np.uint64)   # trips threshold
    svc.insert(ins)
    rsvc.insert(ins)
    assert svc.stats.merges == rsvc.stats.merges == 1 and svc.n_pending == 0
    assert svc.plan is not None and svc.plan is not plan0
    _plans_equal(svc.plan, RD.plan_placement(rsvc._state.snapshot, 2))
    logical = svc.snapshot.keys
    q = np.concatenate([ins, keys[rng.integers(0, keys.size, 2_000)]])
    _hold(svc.lookup(q), rsvc.lookup(q, backend="jnp"), q, logical)


def test_pinned_plan_rebound_after_merge(rng):
    """A pinned plan is honoured only while it matches the exact shard
    table it was cut from; a merge (shifted offsets and minima, same shard
    count) re-plans instead of routing with stale boundaries."""
    keys = np.unique(sorted_u64(rng, 30_000))
    base = PlexService(keys.copy(), eps=32, n_shards=3, block=BLOCK,
                       device=CPU)
    pinned = plan_placement(base.snapshot, 2)
    svc = PlexService(keys.copy(), eps=32, n_shards=3, block=BLOCK,
                      device=CPU, backend="torch", devices=_pdevices(2),
                      plan=pinned, merge_threshold=0)
    assert svc.plan is pinned            # identical build -> honoured
    ins = rng.integers(0, 1 << 62, 500, dtype=np.uint64)
    svc.insert(ins)
    svc.merge()
    assert svc.plan is not pinned and svc.plan.n_devices == 2
    rsnap = RSnap.build(svc.snapshot.keys.copy(), 32, n_shards=3)
    _plans_equal(svc.plan, RD.plan_placement(rsnap, 2))
    logical = svc.snapshot.keys
    q = np.concatenate([ins, keys[rng.integers(0, keys.size, 2_000)]])
    assert np.array_equal(svc.lookup(q), np.searchsorted(logical, q, "left"))


def test_stale_plan_rejected_by_partition_and_loader(rng, tmp_path):
    """partition_stacked and open_routed bind-check the plan against the
    actual shard table, not only the shard count, as the reference's do."""
    keys = np.unique(sorted_u64(rng, 20_000))
    snap_a = Snapshot.build(keys.copy(), 32, n_shards=2, device=CPU)
    other = np.unique(sorted_u64(np.random.default_rng(99), 20_000))
    snap_b = Snapshot.build(other.copy(), 32, n_shards=2, device=CPU)
    plan_b = plan_placement(snap_b, 2)       # same count, different table
    with pytest.raises(ValueError, match="does not match"):
        partition_stacked(snap_a, plan_b, _pdevices(2), block=BLOCK,
                          backend="torch")
    with pytest.raises(ValueError, match="plan spans"):
        partition_stacked(snap_a, plan_placement(snap_a, 2), _pdevices(1),
                          block=BLOCK, backend="torch")
    r_save_snapshot(tmp_path / "g0", RSnap.build(keys.copy(), 32,
                                                 n_shards=2), fsync=False)
    with pytest.raises(ValueError, match="does not match"):
        open_routed(tmp_path / "g0", plan_b, _pdevices(2), block=BLOCK,
                    backend="torch")
    rplan_b = RD.plan_placement(RSnap.build(other.copy(), 32, n_shards=2), 2)
    with pytest.raises(ValueError, match="does not match"):
        RD.open_routed(tmp_path / "g0", rplan_b, _rdevices(2), block=BLOCK)


def test_service_plan_validation(rng):
    keys = sorted_u64(rng, 5_000)
    for bad in (0, 5, "everywhere"):
        with pytest.raises(ValueError, match="plan"):
            PlexService(keys.copy(), eps=32, device=CPU,
                        devices=_pdevices(4), plan=bad)
    for bad in (0, len(jax.devices()) + 1, "everywhere"):
        with pytest.raises(ValueError, match="plan"):
            RService(keys.copy(), eps=32, plan=bad)
    with pytest.raises(ValueError, match="devices"):
        PlexService(keys.copy(), eps=32, device=CPU, devices=[], plan=1)
    # a CPU service's default slot list is its device; a host backend has
    # no stacked path and so no router, as in the reference
    svc = PlexService(keys.copy(), eps=32, device=CPU, plan=1)
    assert svc.devices == [CPU] and svc.plan is not None
    host = PlexService(keys.copy(), eps=32, device=CPU, backend="numpy",
                       plan=1)
    assert host.plan is None
    assert RService(keys.copy(), eps=32, backend="numpy", plan=1).plan \
        is None


def test_service_plan_stats_accounting(rng):
    keys = np.unique(sorted_u64(rng, 30_000))
    svc = _planned(keys, 4)
    rsvc = _rplanned(keys)
    q = keys[rng.integers(0, keys.size, 2 * BLOCK + 77)]
    svc.lookup(q)
    rsvc.lookup(q, backend="jnp")
    assert svc.stats.queries == rsvc.stats.queries == q.size
    assert svc.stats.inflight_batches == rsvc.stats.inflight_batches == 0
    assert svc.stats.drained_batches == svc.stats.batches >= \
        svc.plan.n_active
    t = svc.submit(q[:100])
    assert t.ready
    assert np.array_equal(t.result(),
                          np.searchsorted(keys, q[:100], "left"))


# ------------------------------------------------- partial snapshot load ----

def test_partial_load_maps_strictly_fewer_bytes(rng, tmp_path):
    """A shard_range load of a generation the reference wrote maps strictly
    fewer bytes than a full load, as many as the reference's own partial
    load, and its local view matches the global arrays."""
    keys = sorted_u64(rng, 40_000)
    r_save_snapshot(tmp_path / "g0", RSnap.build(keys.copy(), 32,
                                                 n_shards=4), fsync=False)
    full = load_snapshot(tmp_path / "g0", device=CPU)
    assert full.mapped_bytes == r_load_snapshot(tmp_path / "g0").mapped_bytes
    part = load_snapshot(tmp_path / "g0", shard_range=(1, 3), verify=True,
                         device=CPU)
    rpart = r_load_snapshot(tmp_path / "g0", shard_range=(1, 3))
    assert 0 < part.mapped_bytes == rpart.mapped_bytes < full.mapped_bytes
    lo, hi = int(full.offsets[1]), int(full.offsets[3])
    assert part.key_base == lo and part.shard_base == 1
    assert np.array_equal(np.asarray(part.keys), keys[lo:hi])
    assert np.array_equal(part.offsets + part.key_base, full.offsets[1:3])
    assert part.n_shards == 2
    plan = plan_from_dir(tmp_path / "g0", 8)
    for d in plan.active:
        p = load_snapshot(tmp_path / "g0", shard_range=plan.shard_range(d),
                          device=CPU)
        assert p.mapped_bytes < full.mapped_bytes
        assert p.mapped_bytes == r_load_snapshot(
            tmp_path / "g0", shard_range=plan.shard_range(d)).mapped_bytes


def test_partial_load_shard_range_validation(rng, tmp_path):
    keys = sorted_u64(rng, 10_000)
    save_snapshot(tmp_path / "g0", Snapshot.build(keys, 32, n_shards=2,
                                                  device=CPU), fsync=False)
    for bad in ((2, 1), (-1, 1), (0, 3)):
        with pytest.raises(ValueError):
            load_snapshot(tmp_path / "g0", shard_range=bad, device=CPU)
        with pytest.raises(ValueError):
            r_load_snapshot(tmp_path / "g0", shard_range=bad)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_from_dir_matches_in_memory_plan(writer, rng, tmp_path):
    """Either package plans from either package's generation the plan both
    cut in memory."""
    keys = sorted_u64(rng, 40_000)
    rsnap, psnap = _snapshots(keys, n_shards=5)
    if writer == "reference":
        r_save_snapshot(tmp_path / "g0", rsnap, fsync=False)
    else:
        save_snapshot(tmp_path / "g0", psnap, fsync=False)
    from_disk = plan_from_dir(tmp_path / "g0", 3)
    _plans_equal(from_disk, plan_placement(psnap, 3))
    _plans_equal(from_disk, RD.plan_from_dir(tmp_path / "g0", 3))
    _plans_equal(from_disk, plan_placement(
        load_snapshot(tmp_path / "g0", device=CPU), 3))
    hot = np.arange(1.0, 6.0)
    _plans_equal(plan_from_dir(tmp_path / "g0", 3, hotness=hot),
                 RD.plan_from_dir(tmp_path / "g0", 3, hotness=hot))


def test_open_routed_partial_serves(rng, tmp_path):
    """Plan from the header, partial-load every slot, serve routed: on a
    generation the reference wrote, each slot maps only its slice, the
    total maps what the reference's open_routed maps, and the ranks are the
    reference's."""
    keys = np.unique(sorted_u64(rng, 50_000))
    r_save_snapshot(tmp_path / "g0", RSnap.build(keys.copy(), 32,
                                                 n_shards=4), fsync=False)
    full_bytes = load_snapshot(tmp_path / "g0", device=CPU).mapped_bytes
    plan = plan_from_dir(tmp_path / "g0", 4)
    router, snaps, mapped = open_routed(
        tmp_path / "g0", plan, _pdevices(plan.n_devices), block=BLOCK,
        backend="torch")
    rrouter, _, rmapped = RD.open_routed(
        tmp_path / "g0", RD.plan_from_dir(tmp_path / "g0", 4),
        _rdevices(4), block=BLOCK)
    assert len(snaps) == plan.n_active
    assert mapped == rmapped == sum(s.mapped_bytes for s in snaps)
    for s in snaps:
        assert s.mapped_bytes < full_bytes
    q = np.concatenate([keys[rng.integers(0, keys.size, 3_000)],
                        rng.integers(0, 1 << 62, 1_000, dtype=np.uint64)])
    _hold(router.lookup(q)[0], rrouter.lookup(q)[0], q, keys)


# ------------------------------------------------------------ device loss ----

def test_partition_fault_every_device_falls_back_to_legacy(rng):
    """One trip per re-plan: once every slot has been dropped, the service
    serves without a router (the reference's legacy path)."""
    keys = sorted_u64(rng, 20_000)
    with FAULTS.injected(POINT_PARTITION_LOAD, fail_n(1)):
        svc = PlexService(keys.copy(), eps=32, n_shards=2, block=BLOCK,
                          device=CPU, backend="torch", plan=1)
    with RFAULTS.injected(POINT_PARTITION_LOAD, r_fail_once()):
        rsvc = RService(keys.copy(), eps=32, n_shards=2, block=BLOCK, plan=1)
    assert svc.plan is None and rsvc.plan is None
    q = _queries(rng, keys, 2_000, 400)
    _hold(svc.lookup(q), rsvc.lookup(q, backend="jnp"), q, keys)
    assert svc.health()["routed_devices"] == 0
    assert any("PartitionLoadError" in e for e in svc.health()["last_errors"])


def test_partition_load_error_names_the_device(rng):
    keys = sorted_u64(rng, 20_000)
    rsnap, psnap = _snapshots(keys, n_shards=2)
    with FAULTS.injected(POINT_PARTITION_LOAD, fail_once(device=1)):
        with pytest.raises(PartitionLoadError) as ei:
            partition_stacked(psnap, plan_placement(psnap, 2), _pdevices(2),
                              block=BLOCK, backend="torch")
    with RFAULTS.injected(POINT_PARTITION_LOAD, r_fail_once(device=1)):
        with pytest.raises(RPartitionLoadError) as rei:
            RD.partition_stacked(rsnap, RD.plan_placement(rsnap, 2),
                                 _rdevices(2), block=BLOCK)
    assert ei.value.device_index == rei.value.device_index == 1
    assert ei.value.device == CPU


def test_device_loss_replans_onto_survivors(rng, tmp_path):
    """A full plan has no spare slot: dropping the failed one re-plans at
    reduced capacity (8 -> 7), the reference's plan over 7 devices, and
    writes a ``device.loss`` incident bundle."""
    mgr = incident_mod.install(tmp_path / "inc")
    keys = sorted_u64(rng, 40_000)
    with FAULTS.injected(POINT_PARTITION_LOAD, fail_once(device=2)):
        svc = _planned(keys, 8, n_shards=8)
    assert svc.plan is not None and svc.plan.n_devices == 7
    _plans_equal(svc.plan, RD.plan_placement(
        RSnap.build(keys.copy(), 32, n_shards=8), 7))
    q = _queries(rng, keys, 2_000, 400)
    assert np.array_equal(svc.lookup(q), np.searchsorted(keys, q, "left"))
    assert svc.health()["routed_devices"] == 7
    bundles = mgr.bundles()
    assert len(bundles) == 1 and bundles[0].name.endswith("device-loss")
    assert "device 2" in (bundles[0] / "incident.json").read_text()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_open_routed_replan_on_device_failure(writer, rng, tmp_path):
    """``on_device_failure="raise"`` propagates a slot's failed partial
    load; ``"replan"`` drops it and serves over 3 slots, as the
    reference's does on the same generation."""
    keys = sorted_u64(rng, 40_000)
    rsnap, psnap = _snapshots(keys, n_shards=8)
    if writer == "reference":
        r_save_snapshot(tmp_path / "g0", rsnap, fsync=False)
    else:
        save_snapshot(tmp_path / "g0", psnap, fsync=False)
    gen_dir = tmp_path / "g0"
    plan = plan_from_dir(gen_dir, 4)
    with FAULTS.injected(POINT_PARTITION_LOAD, fail_once(device=1)):
        with pytest.raises(PartitionLoadError):
            open_routed(gen_dir, plan, _pdevices(4), block=BLOCK,
                        backend="torch")
    with FAULTS.injected(POINT_PARTITION_LOAD, fail_once(device=1)):
        router, _, _ = open_routed(gen_dir, plan, _pdevices(4), block=BLOCK,
                                   backend="torch",
                                   on_device_failure="replan")
    with RFAULTS.injected(POINT_PARTITION_LOAD, r_fail_once(device=1)):
        rrouter, _, _ = RD.open_routed(
            gen_dir, RD.plan_from_dir(gen_dir, 4), _rdevices(4), block=BLOCK,
            on_device_failure="replan")
    assert router.plan.n_devices == rrouter.plan.n_devices == 3
    _plans_equal(router.plan, rrouter.plan)
    q = _queries(rng, keys, 2_000, 400)
    batch = router.dispatch(q, None)
    _hold(batch.assemble(q.size), rrouter.dispatch(q, None).assemble(q.size),
          q, keys)
    with pytest.raises(ValueError, match="on_device_failure"):
        open_routed(gen_dir, plan, _pdevices(4), block=BLOCK,
                    on_device_failure="ignore")


def test_service_merge_device_loss_keeps_ranks(rng, tmp_path):
    """The chip phase's drill on the CPU: a 4-slot service takes inserts
    and deletes, merges and re-plans; a slot failing at the next merge's
    partition drops to 3 slots with a ``device.loss`` bundle, and the
    ranks stay exact."""
    mgr = incident_mod.install(tmp_path / "inc")
    keys = np.unique(sorted_u64(rng, 40_000))
    svc = _planned(keys, 4, n_shards=8, merge_threshold=0)
    assert svc.health()["routed_devices"] == 4
    ins = rng.integers(0, 1 << 62, 500, dtype=np.uint64)
    dels = np.unique(keys[rng.integers(0, keys.size, 300)])
    svc.insert(ins)
    svc.delete(dels)
    logical = svc.logical_keys()
    q = np.concatenate([logical[rng.integers(0, logical.size, 3_000)],
                        rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    assert np.array_equal(svc.lookup(q), np.searchsorted(logical, q))
    plan0 = svc.plan
    assert svc.merge()
    assert svc.plan is not plan0 and svc.plan.n_devices == 4
    assert np.array_equal(svc.lookup(q), np.searchsorted(logical, q))
    svc.insert(ins[:50])
    with FAULTS.injected(POINT_PARTITION_LOAD, fail_once(device=3)):
        assert svc.merge()
    assert svc.health()["routed_devices"] == 3
    logical = svc.logical_keys()
    assert np.array_equal(svc.lookup(q), np.searchsorted(logical, q))
    assert [b.name.split("-", 1)[1] for b in mgr.bundles()] == \
        ["device-loss"]


def test_routed_counted_fold_per_slot(rng):
    """The counted dispatch folds every slot's counter plane at its first
    shard: the live hotness equals ``np.bincount(svc.route(q))``, and the
    probe histogram sums to the queries."""
    keys = np.unique(sorted_u64(rng, 40_000))
    svc = _planned(keys, 3, n_shards=6)
    METRICS.enable()
    q = keys[rng.integers(0, keys.size, 5_000)]
    svc.lookup(q)
    want = np.bincount(svc.route(q), minlength=svc.n_shards)
    assert np.array_equal(svc.live_hotness(), want)
    assert svc.probe_trip_hist().sum() == q.size
    # a merge re-plans skew-aware from that fold (same shard count)
    svc.insert(keys[:1] + np.uint64(1))
    svc.merge()
    _plans_equal(svc.plan, RD.plan_placement(
        RSnap.build(svc.snapshot.keys.copy(), 32, n_shards=6), 3,
        hotness=want.astype(float)))


def test_slot_partitions_own_streams_only_on_the_card(rng):
    """Every slot of a repeated-device list is a partition of its own (its
    own slab; a stream of its own on a card, none on the CPU)."""
    keys = np.unique(sorted_u64(rng, 20_000))
    svc = _planned(keys, 4)
    parts = svc._state.router.parts
    assert len({id(p.impl) for p in parts}) == 4
    assert len({id(p.impl.planes.dk) for p in parts}) == 4
    assert all(p.stream is None and p.device == CPU for p in parts)
    assert [(p.shard_lo, p.shard_hi) for p in parts] == \
        [svc.plan.shard_range(d) for d in range(4)]


def _imported_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("rel", DISTRIB)
def test_distrib_imports_no_collectives(rel):
    names = _imported_names(ROOT / "src" / "repro_torch" / rel)
    bad = {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")
           or n.startswith("torch.distributed")}
    assert not bad, f"{rel} imports {sorted(bad)}"


# ------------------------------------------------------------ on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("n_dev", [1, 4])
def test_routed_through_k1_on_card(n_dev):
    """On a CUDA card: slots repeating the card, each with its own stream,
    serve every micro-batch through K1 (one launch each, no plain call),
    with a live delta, equal to searchsorted (``python3 chip_smoke.py``'s
    ``routed`` phase does the same at 200M keys)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    keys = np.unique(sorted_u64(rng, 1 << 20))
    dev = torch.device("cuda", 0)
    svc = PlexService(keys.copy(), eps=64, n_shards=8, block=1 << 14,
                      devices=[dev] * n_dev, plan=n_dev, merge_threshold=0)
    parts = svc._state.router.parts
    assert all(p.stream is not None for p in parts)
    assert len({p.stream.cuda_stream for p in parts}) == n_dev
    svc.insert(rng.integers(0, 1 << 62, 1000, dtype=np.uint64))
    logical = svc.logical_keys()
    q = _queries(rng, logical, 1 << 16, 1 << 12)
    SL.launches = SL.plain_calls = 0
    out = svc.lookup(q)
    assert np.array_equal(out, np.searchsorted(logical, q))
    dev_of = svc.plan.device_of(q)
    want = sum(-(-int(np.sum(dev_of == d)) // svc.block)
               for d in svc.plan.active)
    assert SL.launches == want and SL.plain_calls == 0
    svc.close()


@pytest.mark.gpu
def test_open_routed_through_k1_on_card(tmp_path):
    """On a CUDA card: four slots partial-loaded from one generation serve
    through K1, each mapping less than a full load."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7)
    keys = np.unique(sorted_u64(rng, 1 << 20))
    save_snapshot(tmp_path / "g0", Snapshot.build(keys, 64, n_shards=8,
                                                  device=CPU), fsync=False)
    full = load_snapshot(tmp_path / "g0", device=CPU).mapped_bytes
    plan = plan_from_dir(tmp_path / "g0", 4)
    router, snaps, _ = open_routed(tmp_path / "g0", plan,
                                   [torch.device("cuda", 0)] * 4,
                                   block=1 << 14)
    assert all(s.mapped_bytes < full for s in snaps)
    q = _queries(rng, keys, 1 << 16, 1 << 12)
    SL.launches = 0
    out, batch = router.lookup(q)
    assert np.array_equal(out, np.searchsorted(keys, q))
    assert SL.launches == batch.n_batches
