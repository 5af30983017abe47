"""The port's lean PlexService against the reference's, step by step.

The same keys, lookups, inserts, deletes and merges go through
``repro.serving.PlexService(backend="jnp")`` and
``repro_torch.serving.PlexService(device="cpu")``; every answer must be
identical (past the end of a narrow radix shard, where the reference's
radix prefix wraps, the port's equals searchsorted instead: R5), and
present keys must equal searchsorted over the logical key array. Both the fused path (shards unify) and the per-shard path (mixed
radix/CHT shards) are driven. ``convert.snapshot_from_arrays`` is held to
serve a reference-built index unchanged.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.index import Snapshot as RSnap
from repro.data import generate
from repro.kernels import planes as RP
from repro.kernels.jnp_lookup import StackedJnpPlex
from repro.serving import PlexService as RService
from repro_torch.convert import snapshot_from_arrays
from repro_torch.kernels import planes as TP
from repro_torch.serving import PlexService

from test_torch_stacked_lookup import _wrapped

U64_MAX = (1 << 64) - 1

CASES = {
    # name: (dataset, n, shards, fused?)
    "fused": ("amzn", 60_000, 3, True),
    "per_shard": ("face", 100_000, 2, False),
}


def _queries(logical, rng):
    edges = np.asarray([0, 1, U64_MAX, U64_MAX - 1, min(int(logical[-1]) + 1, U64_MAX)],
                       np.uint64)
    return np.concatenate([
        edges, logical[rng.integers(0, logical.size, 2_000)],
        rng.integers(0, U64_MAX, 300, dtype=np.uint64, endpoint=True),
        rng.integers(logical[0], logical[-1], 300, dtype=np.uint64)])


def _check(port, ref, rng):
    logical = port.logical_keys()
    assert np.array_equal(logical, ref.logical_keys())
    q = _queries(logical, rng)
    got = port.lookup(q)
    assert np.array_equal(got, ref.lookup(q))
    present = np.isin(q, logical)
    assert np.array_equal(got[present],
                          np.searchsorted(logical, q[present], "left"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_service_matches_reference_through_updates(case):
    name, n, shards, fused = CASES[case]
    rng = np.random.default_rng(9)
    keys = generate(name, n, 0)
    ref = RService(keys.copy(), eps=32, n_shards=shards, block=512,
                   backend="jnp")
    port = PlexService(keys.copy(), eps=32, n_shards=shards, block=512,
                       device="cpu")
    assert port.fused is fused
    assert (ref.stacked_impl() is not None) is fused
    _check(port, ref, rng)
    ins = np.concatenate([rng.integers(keys[0], keys[-1], 400,
                                       dtype=np.uint64),
                          keys[rng.integers(0, keys.size, 50)],
                          np.asarray([0, U64_MAX], np.uint64)])
    assert port.insert(ins) == ref.insert(ins)
    _check(port, ref, rng)
    dels = keys[rng.integers(0, keys.size, 250)]
    assert port.delete(dels) == ref.delete(dels)
    port.insert(dels[:10])
    ref.insert(dels[:10])
    assert port.n_pending == ref.n_pending > 0
    _check(port, ref, rng)
    assert port.merge() and ref.merge()
    assert port.n_pending == 0 and port.stats.merges == 1
    _check(port, ref, rng)
    assert port.merge() is False


def test_auto_merge_at_threshold():
    rng = np.random.default_rng(4)
    keys = generate("osm", 20_000, 0)
    port = PlexService(keys.copy(), eps=16, n_shards=2, block=256,
                       merge_threshold=200, device="cpu")
    port.insert(rng.integers(keys[0], keys[-1], 150, dtype=np.uint64))
    assert port.stats.merges == 0 and port.n_pending == 150
    port.insert(rng.integers(keys[0], keys[-1], 60, dtype=np.uint64))
    assert port.stats.merges == 1 and port.n_pending == 0
    logical = port.logical_keys()
    q = logical[rng.integers(0, logical.size, 1_000)]
    assert np.array_equal(port.lookup(q),
                          np.searchsorted(logical, q, "left"))


def test_one_dispatch_per_microbatch():
    keys = generate("amzn", 20_000, 0)
    port = PlexService(keys, eps=16, n_shards=2, block=256, device="cpu")
    assert port.fused
    port.lookup(keys[:1_000])
    assert port.stats.batches == 4          # ceil(1000 / 256), unpadded
    assert port.lookup(np.zeros(0, np.uint64)).size == 0


def test_per_shard_path_one_dispatch_per_shard_microbatch():
    keys = generate("face", 100_000, 0)
    port = PlexService(keys, eps=32, n_shards=2, block=256, device="cpu")
    assert not port.fused
    q = keys[np.random.default_rng(1).integers(0, keys.size, 1_500)]
    counts = np.bincount(port.snapshot.route(q), minlength=2)
    got = port.lookup(q)
    assert port.stats.batches == int(np.sum(-(-counts // 256)))
    assert np.array_equal(got, np.searchsorted(keys, q, "left"))


def test_service_argument_checks():
    keys = np.arange(1, 2_000, dtype=np.uint64)
    with pytest.raises(ValueError, match="multiple of 128"):
        PlexService(keys, block=100, device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        PlexService(keys[::-1], device="cpu")
    with pytest.raises(ValueError, match="probe"):
        PlexService(keys, probe="scan", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        PlexService(keys[:0], device="cpu")


def _arrays(snap: RSnap):
    """What a reference snapshot holds, as plain arrays."""
    shards = []
    for s in snap.shards:
        px = s.plex
        if px.layer.__class__.__name__ == "RadixTable":
            layer = dict(kind="radix", table=px.layer.table,
                         shift=px.layer.shift, r=px.layer.r,
                         min_key=px.layer.min_key)
        else:
            layer = dict(kind="cht", cells=px.layer.cells, r=px.layer.r,
                         delta=px.layer.delta, max_depth=px.layer.max_depth)
        shards.append(dict(spline_keys=px.spline.keys,
                           spline_positions=px.spline.positions,
                           layer=layer,
                           tuning=dataclasses.asdict(px.tuning)))
    return snap.keys, snap.offsets, shards


@pytest.mark.parametrize("name", ["wiki", "face"])
def test_snapshot_from_arrays_serves_reference_index(name):
    rng = np.random.default_rng(6)
    keys = generate(name, 100_000, 2)
    ref = RSnap.build(keys.copy(), 32, n_shards=2)
    port = snapshot_from_arrays(*_arrays(ref), eps=32, device="cpu")
    assert np.array_equal(port.offsets, ref.offsets)
    for s, (a, b) in enumerate(zip(port.shards, ref.shards)):
        hp_a = TP._host_statics(a)
        hp_b = RP._host_statics(b.plex)
        assert (hp_a.kind, hp_a.eps_eff, hp_a.window, hp_a.n_data) == \
            (hp_b.kind, hp_b.eps_eff, hp_b.window, hp_b.n_data)
        q = _queries(a.keys, rng)
        impl = port.shard_impl(s, block=512)
        got = impl.lookup(q)
        want = StackedJnpPlex.from_plexes([b.plex], np.zeros(1, np.int64),
                                          block=512, probe="bisect").lookup(q)
        # past the end of a narrow radix shard the reference's prefix
        # wraps and the port's saturates (R5)
        wrap = _wrapped(impl.planes, q)
        assert np.array_equal(got[~wrap], want[~wrap])
        assert np.array_equal(got[wrap],
                              np.searchsorted(a.keys, q[wrap], "left"))
    st = port.stacked_impl(block=512)
    rj = StackedJnpPlex.from_plexes([s.plex for s in ref.shards],
                                    ref.offsets, block=512, probe="bisect")
    assert (st is None) == (rj is None)
    if st is not None:
        q = _queries(keys, rng)
        got, wrap = st.lookup(q), _wrapped(st.planes, q)
        assert np.array_equal(got[~wrap], rj.lookup(q)[~wrap])
        assert np.array_equal(got[wrap],
                              np.searchsorted(keys, q[wrap], "left"))


def test_delta_buffer_matches_reference():
    from repro.serving.delta import DeltaBuffer as RDelta
    from repro_torch.serving.delta import DeltaBuffer as TDelta
    rng = np.random.default_rng(8)
    keys = np.sort(rng.integers(0, 1 << 40, 5_000, dtype=np.uint64))
    keys[100:120] = keys[100]                     # a duplicate run
    ref, port = RDelta(keys), TDelta(keys)
    ops = [("insert", rng.integers(0, 1 << 40, 200, dtype=np.uint64)),
           ("delete", np.concatenate([keys[[100, 7, 7, 4_999]],
                                      np.asarray([3], np.uint64)])),
           ("insert", keys[[100, 7]]),
           ("delete", rng.integers(0, 1 << 40, 50, dtype=np.uint64))]
    q = np.concatenate([keys[::7], rng.integers(0, 1 << 40, 500,
                                                dtype=np.uint64)])
    for name, k in ops:
        assert getattr(port, name)(k) == getattr(ref, name)(k)
        assert port.n_entries == ref.n_entries
        assert np.array_equal(port.adjust(q), ref.adjust(q))
        assert np.array_equal(port.logical_keys(), ref.logical_keys())
    big = TDelta(keys, capacity=128)
    big.insert(rng.integers(0, 1 << 40, 300, dtype=np.uint64))
    view = big.device_view("cpu")
    assert view.cap == 512 and view.n_entries == 300
    assert big.device_view("cpu") is view         # cached until mutated


def _load_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", sorted(CASES))
def test_smoke_replays_the_served_launches(case):
    """``chip_smoke.py``'s hold on the main path, on the CPU: a served
    request's launches are recorded as made, replay equal to the plain
    version, and the request's byte bound counts each query's key and rank
    and at most five sectors a query."""
    from repro_torch.kernels import stacked_lookup as SL
    name, n, shards, fused = CASES[case]
    smoke = _load_smoke()
    keys = generate(name, n, 0)
    port = PlexService(keys, eps=32, n_shards=shards, block=512,
                       device="cpu")
    assert port.fused is fused
    q = _queries(keys, np.random.default_rng(3))
    b0 = port.stats.batches
    with smoke.recorded_launches() as rec:
        port.lookup(q)
    assert SL.stacked_lookup is rec._orig
    assert len(rec.calls) == port.stats.batches - b0 > 0
    assert sum(c[2].numel() for c in rec.calls) == q.size
    assert smoke.replay(rec.calls, port.device)["max_abs_err"] == 0
    nbytes = smoke.bound_bytes(port.snapshot, q)
    assert q.size * 12 + 32 <= nbytes <= q.size * (12 + 5 * 32)
