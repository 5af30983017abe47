"""The port's parallel sharded build: bit-identity, streaming, transports,
faults — ``tests/test_parallel_build.py``'s tests through
``repro_torch.core``, then parity with the reference's ``build_generation``
(byte-identical files), the start-method rule (a spawned worker imports
neither jax nor initialises CUDA) and the spawn transport's spill from a
full ``/dev/shm`` to the temporary directory."""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import pathlib
import types

import numpy as np
import pytest

from repro.core import parallel_build as RPB
from repro_torch.core import parallel_build as PB
from repro_torch.core.index import Snapshot, shard_offsets
from repro_torch.core.parallel_build import (build_generation,
                                             build_shard_plexes,
                                             iter_built_shards, spans_of)
from repro_torch.core.plex import BuildStats
from repro_torch.persist.format import load_snapshot, save_snapshot
from repro_torch.resilience.faults import (FAULTS, POINT_BUILD_SHARD,
                                           fail_once, injected)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _keys(n: int = 200_000, seed: int = 3, spread: int = 62) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 2**spread, n, dtype=np.uint64))


def _build(keys, eps, **kw):
    return Snapshot.build(keys, eps, device="cpu", **kw)


def _layer_arr(px):
    return px.layer.table if hasattr(px.layer, "table") else px.layer.cells


def _snap_lookup(snap: Snapshot, q: np.ndarray) -> np.ndarray:
    """Routed host lookup over a snapshot (global indices)."""
    sid = snap.route(q)
    out = np.empty(q.size, dtype=np.int64)
    for s in np.unique(sid):
        m = sid == s
        out[m] = snap.shards[s].lookup(q[m]) + int(snap.offsets[s])
    return out


def assert_snapshots_identical(a: Snapshot, b: Snapshot) -> None:
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.offsets, b.offsets)
    assert a.n_shards == b.n_shards
    for px, py in zip(a.shards, b.shards):
        assert (px.tuning.kind, px.tuning.r, px.tuning.delta) == \
            (py.tuning.kind, py.tuning.r, py.tuning.delta)
        assert np.array_equal(px.spline.keys, py.spline.keys)
        assert np.array_equal(px.spline.positions, py.spline.positions)
        assert np.array_equal(_layer_arr(px), _layer_arr(py))


@pytest.mark.parametrize("pool", ["process", "thread"])
def test_parallel_build_bit_identical(pool):
    keys = _keys()
    serial = _build(keys.copy(), 64, n_shards=5)
    par = _build(keys.copy(), 64, n_shards=5, workers=3, pool=pool)
    assert_snapshots_identical(serial, par)
    q = keys[::311]
    assert np.array_equal(_snap_lookup(par, q),
                          np.searchsorted(keys, q, "left"))


def test_parallel_build_persisted_bytes_identical(tmp_path):
    keys = _keys(120_000)
    serial = _build(keys.copy(), 32, n_shards=4)
    par = _build(keys.copy(), 32, n_shards=4, workers=2)
    # build_s is wall-clock metadata embedded in the snapshot header —
    # never index content — so it is equalised before the byte comparison
    par.build_s = serial.build_s
    save_snapshot(tmp_path / "a", serial, fsync=False)
    save_snapshot(tmp_path / "b", par, fsync=False)
    assert (tmp_path / "a/snapshot.plex").read_bytes() == \
        (tmp_path / "b/snapshot.plex").read_bytes(), "persisted bytes differ"


def test_build_stats_aggregate_on_snapshot():
    keys = _keys(80_000)
    snap = _build(keys.copy(), 64, n_shards=3, workers=2)
    st = snap.build_stats
    assert isinstance(st, BuildStats)
    per_shard = [px.stats for px in snap.shards]
    assert st.total_s == pytest.approx(sum(p.total_s for p in per_shard))
    assert st.spline_s == pytest.approx(sum(p.spline_s for p in per_shard))
    assert st.tune_s == pytest.approx(sum(p.tune_s for p in per_shard))
    assert st.layer_s == pytest.approx(sum(p.layer_s for p in per_shard))
    # phases partition (approximately) the per-shard total
    assert st.spline_s + st.tune_s + st.layer_s == pytest.approx(
        st.total_s, rel=0.05)


def test_iter_built_shards_yields_in_order():
    keys = _keys(100_000)
    offsets = shard_offsets(keys, 4)
    got = list(iter_built_shards(keys, offsets, 64, workers=3))
    assert [s for s, _ in got] == [0, 1, 2, 3]
    spans = spans_of(offsets, keys.size)
    for (s, px), (lo, hi) in zip(got, spans):
        # the parent re-attaches its own keys view, same as the serial path
        assert px.keys.size == hi - lo
        assert np.shares_memory(px.keys, keys)


def test_memmap_keys_transport(tmp_path):
    keys = _keys(90_000)
    raw = tmp_path / "keys.bin"
    keys.tofile(raw)
    km = np.memmap(raw, dtype=np.uint64, mode="r")
    offsets = shard_offsets(np.asarray(km), 3)
    par = build_shard_plexes(np.asarray(km), offsets, 64, workers=2)
    ser = build_shard_plexes(keys, offsets, 64, workers=1)
    for a, b in zip(par, ser):
        assert np.array_equal(a.spline.keys, b.spline.keys)
        assert np.array_equal(a.spline.positions, b.spline.positions)


def test_build_generation_round_trip(tmp_path):
    keys = _keys(150_000)
    gen_dir = build_generation(tmp_path, keys.copy(), 64, n_shards=4,
                               workers=2, fsync=False)
    snap = load_snapshot(gen_dir, verify=True, device="cpu")
    ref = _build(keys.copy(), 64, n_shards=4)
    assert np.array_equal(np.asarray(snap.keys), ref.keys)
    assert np.array_equal(np.asarray(snap.offsets), ref.offsets)
    for x, y in zip(snap.shards, ref.shards):
        assert np.array_equal(np.asarray(x.spline.keys), y.spline.keys)
        assert np.array_equal(np.asarray(x.spline.positions),
                              y.spline.positions)
    q = keys[::173]
    assert np.array_equal(_snap_lookup(snap, q),
                          np.searchsorted(keys, q, "left"))


def test_build_generation_servable_by_open(tmp_path):
    from repro_torch.serving.plex_service import PlexService
    keys = _keys(100_000)
    build_generation(tmp_path, keys.copy(), 64, n_shards=3, workers=2,
                     fsync=False)
    with PlexService.open(tmp_path, backend="numpy", durable=False,
                          device="cpu") as svc:
        q = keys[::97]
        assert np.array_equal(svc.lookup(q),
                              np.searchsorted(keys, q, "left"))


def test_build_generation_increments_generation(tmp_path):
    keys = _keys(40_000)
    g0 = build_generation(tmp_path, keys.copy(), 64, n_shards=2,
                          fsync=False)
    g1 = build_generation(tmp_path, keys.copy(), 64, n_shards=2,
                          fsync=False)
    assert g0.name == "gen-000000" and g1.name == "gen-000001"


def test_build_shard_fault_aborts_cleanly(tmp_path):
    keys = _keys(60_000)
    with injected(POINT_BUILD_SHARD, fail_once(shard=1)):
        with pytest.raises(Exception):
            build_generation(tmp_path, keys.copy(), 64, n_shards=3,
                             fsync=False)
    assert FAULTS.trips(POINT_BUILD_SHARD) == 1
    # the aborted build swept its temp file and committed nothing
    assert not list(pathlib.Path(tmp_path).glob("gen-*"))
    assert not list(pathlib.Path(tmp_path).glob("**/*.tmp"))


def test_single_shard_build_honours_device():
    """The port's counterpart of the reference's devices test: a build, one
    shard or many, serial or parallel, places its planes on the device it
    was given."""
    import torch
    keys = _keys(20_000)
    snap = Snapshot.build(keys.copy(), 64, n_shards=1, device="cpu")
    assert snap.device == torch.device("cpu")
    multi = Snapshot.build(keys.copy(), 64, n_shards=2, device="cpu",
                           workers=2)
    assert multi.device == torch.device("cpu")
    assert multi.stacked_impl("torch").planes.device == torch.device("cpu")


def test_workers_exceeding_shards_clamped():
    keys = _keys(30_000)
    par = _build(keys.copy(), 64, n_shards=2, workers=16)
    ser = _build(keys.copy(), 64, n_shards=2)
    assert_snapshots_identical(ser, par)


def test_invalid_pool_rejected():
    keys = _keys(10_000)
    offsets = shard_offsets(keys, 2)
    with pytest.raises(ValueError, match="pool"):
        build_shard_plexes(keys, offsets, 64, workers=2, pool="fiber")


# -- the port's own ------------------------------------------------------------

def test_start_method_rule(monkeypatch):
    """Fork while this process has not initialised CUDA, spawn once it has;
    an explicit context wins."""
    import torch
    if "fork" in multiprocessing.get_all_start_methods():
        assert PB._mp_context().get_start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert PB.cuda_initialized()
    assert PB._mp_context().get_start_method() == "spawn"
    assert PB._mp_context("fork").get_start_method() == "fork"


def test_spawned_worker_imports_no_jax_and_no_cuda():
    """A worker made the way the spawn transport makes it: jax is not
    imported and CUDA is not initialised there, and a spawn build is
    bit-identical to the serial one."""
    keys = _keys(60_000)
    ctx = multiprocessing.get_context("spawn")
    desc, cleanup = PB._keys_descriptor(keys, "spawn")
    try:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=1, mp_context=ctx, initializer=PB._pool_init,
                initargs=(desc,)) as ex:
            env = ex.submit(PB.worker_env).result(timeout=120)
    finally:
        cleanup()
    assert env == {"pid": env["pid"], "jax": False,
                   "cuda_initialized": False}
    par = _build(keys.copy(), 64, n_shards=3, workers=2, mp_context="spawn")
    assert_snapshots_identical(_build(keys.copy(), 64, n_shards=3), par)


def test_spawn_transport_spills_past_a_full_dev_shm(monkeypatch, tmp_path):
    """When ``/dev/shm`` cannot hold the keys (plus a margin), the spawn
    transport writes its scratch file to the temporary directory instead;
    the build is the same."""
    keys = _keys(50_000)
    monkeypatch.setattr(PB.tempfile, "tempdir", str(tmp_path))
    real_usage = PB.shutil.disk_usage
    free = {"bytes": 0}

    def usage(path):
        u = real_usage(path)
        return types.SimpleNamespace(total=u.total, used=u.used,
                                     free=free["bytes"])
    monkeypatch.setattr(PB.shutil, "disk_usage", usage)
    assert PB.scratch_dir(keys.nbytes) == str(tmp_path)
    if PB.pathlib.Path(PB.SHM_DIR).is_dir():
        free["bytes"] = keys.nbytes + PB._SHM_SLACK
        assert PB.scratch_dir(keys.nbytes) == PB.SHM_DIR
        free["bytes"] = keys.nbytes       # no room for the margin
        assert PB.scratch_dir(keys.nbytes) == str(tmp_path)
    made = []
    mkstemp = PB.tempfile.mkstemp

    def recording_mkstemp(*a, **kw):
        fd, path = mkstemp(*a, **kw)
        made.append(path)
        return fd, path
    monkeypatch.setattr(PB.tempfile, "mkstemp", recording_mkstemp)
    offsets = shard_offsets(keys, 2)
    par = build_shard_plexes(keys, offsets, 64, workers=2,
                             mp_context="spawn")
    ser = build_shard_plexes(keys, offsets, 64)
    assert [pathlib.Path(p).parent for p in made] == [tmp_path]
    assert not pathlib.Path(made[0]).exists()     # unlinked after the build
    for a, b in zip(par, ser):
        assert np.array_equal(a.spline.keys, b.spline.keys)
        assert np.array_equal(_layer_arr(a), _layer_arr(b))


def test_service_build_workers(tmp_path):
    """``PlexService(build_workers=)``: validated as the reference does,
    used by the constructor's build and by a merge's, bit-identical to a
    serial service's snapshots."""
    from repro_torch.serving.plex_service import PlexService
    keys = _keys(60_000)
    with pytest.raises(ValueError, match="build_workers"):
        PlexService(keys.copy(), 64, build_workers=0, device="cpu")
    kw = dict(n_shards=3, merge_threshold=0, device="cpu")
    par = PlexService(keys.copy(), 64, build_workers=2, **kw)
    ser = PlexService(keys.copy(), 64, **kw)
    try:
        assert par.build_workers == 2 and ser.build_workers is None
        assert_snapshots_identical(ser.snapshot, par.snapshot)
        fresh = np.unique(np.random.default_rng(1).integers(
            0, 2**62, 500, dtype=np.uint64))
        for svc in (par, ser):
            svc.insert(fresh)
            assert svc.merge()
        assert_snapshots_identical(ser.snapshot, par.snapshot)
        par.save(tmp_path / "g")
    finally:
        par.close()
        ser.close()
    back = PlexService.open(tmp_path / "g", build_workers=2, device="cpu")
    try:
        assert back.build_workers == 2
        q = back.logical_keys()[::41]
        assert np.array_equal(back.lookup(q), np.searchsorted(
            back.logical_keys(), q, "left"))
    finally:
        back.close()


@pytest.mark.parametrize("workers", [1, 3])
def test_build_generation_bytes_equal_the_references(tmp_path, monkeypatch,
                                                     workers):
    """The port's ``build_generation`` writes the reference's files byte
    for byte (snapshot, manifest, WAL) on the same keys, serial or
    parallel (keys below 2^53, where the packages' splines agree, R1; the
    wall-clock ``build_s`` is pinned in both)."""
    frozen = types.SimpleNamespace(perf_counter=lambda: 0.0)
    monkeypatch.setattr(PB, "time", frozen)
    monkeypatch.setattr(RPB, "time", frozen)
    keys = _keys(120_000, seed=8, spread=53)
    build_generation(tmp_path / "port", keys.copy(), 64, n_shards=4,
                     workers=workers, fsync=False)
    RPB.build_generation(tmp_path / "ref", keys.copy(), 64, n_shards=4,
                         workers=1, fsync=False)
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    assert len(files) == 3
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "ref" / rel).read_bytes(), rel
