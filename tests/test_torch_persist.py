"""The port's durability layer against the reference's: the counterparts of
``tests/test_persist.py`` (snapshot format, WAL prefix recovery, torn
tails, uncommitted generations, durable merges and GC, reopen parity on
every backend), then the two packages against each other — a generation
written by either opens in the other and serves the writer's ranks, and
for the same snapshot and op sequence the snapshot file, the manifest and
the WAL segment are byte-identical — over a radix-only, a CHT-containing
and a one-point-spline (R4) snapshot.

Every port entry point runs with ``device="cpu"`` (the plain PyTorch
versions); the reference serves through ``backend="jnp"``. The reference's
timing test (open at least 5x faster than the build) is a number of
``chip_smoke.py``'s ``durable`` phase, not an assertion here.
"""
import json
import logging

import numpy as np
import pytest
import torch

from repro.core import Snapshot as RSnap
from repro.data import generate
from repro.persist import format as RF
from repro.persist import manifest as RM
from repro.persist import wal as RW
from repro.serving import PlexService as RService
from repro_torch.convert import snapshot_from_arrays
from repro_torch.core import Snapshot
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.persist.format import SnapshotWriter
from repro_torch.persist import (CorruptManifestError, CorruptSnapshotError,
                                 MANIFEST_NAME, Manifest, OP_DELETE,
                                 OP_INSERT, SNAPSHOT_FILE, WriteAheadLog,
                                 gen_name, load_snapshot,
                                 read_manifest, save_snapshot,
                                 validate_snapshot, wal_name, write_manifest)
from repro_torch.serving import PlexService

from conftest import sorted_u64
from test_torch_service import _arrays

BLOCK = 512
CPU = "cpu"


def _mutated_service(rng, n=30_000, **kw):
    """A 2-shard port service with a live (unmerged) delta + its logical
    model."""
    keys = sorted_u64(rng, n)
    svc = PlexService(keys.copy(), eps=32, n_shards=2, block=BLOCK,
                      merge_threshold=0, device=CPU, **kw)
    ins = rng.integers(0, 1 << 62, n // 50, dtype=np.uint64)
    dels = np.unique(keys[rng.integers(0, keys.size, n // 100)])
    svc.insert(ins)
    svc.delete(dels)
    model = np.sort(np.concatenate(
        [keys[~np.isin(keys, dels)], ins[~np.isin(ins, dels)]]))
    assert np.array_equal(svc.logical_keys(), model)
    return svc, model


def _queries(rng, model, n_present=4_000, n_absent=400):
    q = np.concatenate([model[rng.integers(0, model.size, n_present)],
                        rng.integers(0, 1 << 62, n_absent, dtype=np.uint64)])
    return q, np.searchsorted(model, q, side="left")


# ---------------------------------------------------------------- format ----

def test_snapshot_format_roundtrip(rng, tmp_path):
    keys = sorted_u64(rng, 20_000, dups=True)
    snap = Snapshot.build(keys, eps=16, n_shards=2, device=CPU)
    snap.save(tmp_path / "g0")
    assert validate_snapshot(tmp_path / "g0")
    back = Snapshot.load(tmp_path / "g0", device=CPU)
    assert np.array_equal(back.keys, snap.keys)
    assert np.array_equal(back.offsets, snap.offsets)
    assert back.eps == snap.eps and back.epoch == snap.epoch
    assert back.build_s == pytest.approx(snap.build_s)
    assert back.n_shards == snap.n_shards
    for a, b in zip(back.shards, snap.shards):
        assert np.array_equal(a.spline.keys, b.spline.keys)
        assert np.array_equal(a.spline.positions, b.spline.positions)
        assert a.tuning.kind == b.tuning.kind
        assert a.size_bytes == b.size_bytes
    # mapped arrays satisfy the snapshot freeze contract
    with pytest.raises(ValueError):
        back.keys[0] = 1


def test_loaded_snapshot_serves_from_mapped_planes(rng, tmp_path):
    """The warm stacked path (mapped planes + persisted statics) builds the
    cold path's planes exactly and answers bit for bit, absent keys
    included."""
    keys = sorted_u64(rng, 20_000)
    snap = Snapshot.build(keys.copy(), eps=16, n_shards=2, device=CPU)
    snap.save(tmp_path / "g0")
    back = Snapshot.load(tmp_path / "g0", device=CPU)
    assert back._host_planes_fn is not None
    cold = snap.stacked_impl(block=BLOCK)
    warm = back.stacked_impl(block=BLOCK)
    assert warm.planes.static == cold.planes.static
    assert warm.planes.window == cold.planes.window
    for name in ("sk", "spos", "dk", "n_spline", "row_off", "shard_min"):
        assert torch.equal(getattr(warm.planes, name),
                           getattr(cold.planes, name)), name
    for name, t in cold.planes.layer_arrays.items():
        assert torch.equal(warm.planes.layer_arrays[name], t), name
    assert torch.equal(warm.planes.summary.l1, cold.planes.summary.l1)
    q = np.concatenate([keys[rng.integers(0, keys.size, 2_000)],
                        rng.integers(0, 1 << 62, 200, dtype=np.uint64)])
    assert np.array_equal(warm.lookup(q), cold.lookup(q))
    for s in range(snap.n_shards):
        assert np.array_equal(back.shard_impl(s, block=BLOCK).lookup(q),
                              snap.shard_impl(s, block=BLOCK).lookup(q))


def test_truncated_snapshot_rejected(rng, tmp_path):
    keys = sorted_u64(rng, 10_000)
    snap = Snapshot.build(keys, eps=16, device=CPU)
    path = save_snapshot(tmp_path / "g0", snap)
    whole = path.read_bytes()
    path.write_bytes(whole[:len(whole) // 2])
    with pytest.raises(CorruptSnapshotError):
        load_snapshot(tmp_path / "g0", device=CPU)
    # corrupted plane payload: lazy open passes, full verification fails
    path.write_bytes(whole[:-8] + b"\xde\xad\xbe\xef\xde\xad\xbe\xef")
    load_snapshot(tmp_path / "g0", device=CPU)
    with pytest.raises(CorruptSnapshotError):
        validate_snapshot(tmp_path / "g0")


def test_partial_load_maps_only_its_shards(rng, tmp_path):
    """``shard_range`` (the mesh's partial load) maps strictly less than a
    full load, rebases keys and offsets, and its warm planes serve the
    range's shards as the full snapshot's do."""
    keys = sorted_u64(rng, 30_000)
    snap = Snapshot.build(keys.copy(), eps=16, n_shards=4, device=CPU)
    snap.save(tmp_path / "g0")
    full = Snapshot.load(tmp_path / "g0", device=CPU)
    part = load_snapshot(tmp_path / "g0", shard_range=(1, 3), device=CPU,
                         verify=True)
    assert 0 < part.mapped_bytes < full.mapped_bytes
    assert part.shard_base == 1 and part.key_base == int(snap.offsets[1])
    assert np.array_equal(part.keys, keys[snap.offsets[1]:snap.offsets[3]])
    assert np.array_equal(part.offsets + part.key_base, snap.offsets[1:3])
    lo, hi = part.keys[0], part.keys[-1]
    q = keys[(keys >= lo) & (keys <= hi)][::7]
    st = part.stacked_impl(block=BLOCK)
    assert np.array_equal(st.lookup(q) + part.key_base,
                          np.searchsorted(keys, q, "left"))


def test_snapshot_writer_streams_the_same_file(rng, tmp_path):
    """``SnapshotWriter`` (the streamed build's writer) lays down a file
    that opens to the same snapshot ``save_snapshot`` writes, also when the
    header outgrows its reserve."""
    keys = sorted_u64(rng, 20_000)
    snap = Snapshot.build(keys.copy(), eps=16, n_shards=3, device=CPU)
    for reserve in (None, 64):
        w = SnapshotWriter(tmp_path / f"w{reserve}", reserve=reserve,
                           n_shards_hint=3, fsync=False)
        w.add_plane("keys", snap.keys)
        w.add_plane("offsets", snap.offsets)
        for s, px in enumerate(snap.shards):
            w.add_shard(s, px)
        w.finalize(eps=snap.eps, n_keys=snap.n_keys, build_s=snap.build_s)
        assert validate_snapshot(tmp_path / f"w{reserve}")
        back = Snapshot.load(tmp_path / f"w{reserve}", device=CPU)
        q = keys[::13]
        assert np.array_equal(back.stacked_impl(block=BLOCK).lookup(q),
                              np.searchsorted(keys, q, "left"))
    w = SnapshotWriter(tmp_path / "aborted", fsync=False)
    with pytest.raises(ValueError, match="out of order"):
        w.add_shard(1, snap.shards[1])
    w.abort()
    assert not (tmp_path / "aborted").exists()


# -------------------------------------------------------------- manifest ----

def test_manifest_roundtrip_and_corruption(tmp_path):
    man = Manifest.for_generation(3)
    assert man.snapshot == gen_name(3) and man.wal == wal_name(3)
    write_manifest(tmp_path, man)
    assert read_manifest(tmp_path) == man
    assert read_manifest(tmp_path / "nowhere") is None
    raw = (tmp_path / MANIFEST_NAME).read_text()
    (tmp_path / MANIFEST_NAME).write_text(
        raw.replace(f'"generation": {3}', '"generation": 4'))
    with pytest.raises(CorruptManifestError):
        read_manifest(tmp_path)


# ------------------------------------------------------------------- WAL ----

def test_wal_append_replay_roundtrip(tmp_path):
    wal = WriteAheadLog.create(tmp_path / "w.log", fsync=False)
    a = np.asarray([5, 1, 9], dtype=np.uint64)
    b = np.asarray([7], dtype=np.uint64)
    wal.append(OP_INSERT, a)
    wal.append(OP_DELETE, b)
    wal.append(OP_INSERT, np.zeros(0, dtype=np.uint64))   # empty is legal
    wal.close()
    records, valid, discarded = WriteAheadLog.replay(tmp_path / "w.log")
    assert discarded == 0
    assert valid == (tmp_path / "w.log").stat().st_size
    assert [op for op, _ in records] == [OP_INSERT, OP_DELETE, OP_INSERT]
    assert np.array_equal(records[0][1], a)
    assert np.array_equal(records[1][1], b)
    assert records[2][1].size == 0


def test_wal_prefix_recovery(tmp_path):
    """Torn tails and bit flips cut replay at the last valid record."""
    path = tmp_path / "w.log"
    wal = WriteAheadLog.create(path, fsync=False)
    sizes = [wal.append(OP_INSERT, np.full(i + 1, i, dtype=np.uint64))
             for i in range(4)]
    wal.close()
    data = path.read_bytes()
    path.write_bytes(data[:-sizes[-1] // 2])
    records, valid, discarded = WriteAheadLog.replay(path)
    assert len(records) == 3 and discarded > 0
    assert valid == len(data) - sizes[-1]
    flipped = bytearray(data)
    flipped[8 + sizes[0] + 12] ^= 0xFF
    path.write_bytes(bytes(flipped))
    records, valid, _ = WriteAheadLog.replay(path)
    assert len(records) == 1 and valid == 8 + sizes[0]
    WriteAheadLog.open(path, fsync=False, truncate_at=valid).close()
    assert path.stat().st_size == valid
    path.write_bytes(b"NOTAWAL!" + data[8:])
    records, valid, discarded = WriteAheadLog.replay(path)
    assert records == [] and valid == 0 and discarded > 0
    assert WriteAheadLog.replay(tmp_path / "gone.log") == ([], 0, 0)


def test_wal_rotate_compacts_and_checkpoint_resets_replay(tmp_path):
    path = tmp_path / "w.log"
    wal = WriteAheadLog.create(path, fsync=False)
    for i in range(20):
        wal.append(OP_INSERT, np.full(8, i, dtype=np.uint64))
        wal.append(OP_DELETE, np.full(8, i, dtype=np.uint64))
    grown = wal.size_bytes
    seed = np.asarray([3, 5], dtype=np.uint64)
    wal = wal.rotate([(OP_DELETE, seed), (OP_INSERT, seed)])
    assert path.stat().st_size < grown
    records, valid, discarded = WriteAheadLog.replay(path)
    assert discarded == 0 and valid == path.stat().st_size
    assert [op for op, _ in records] == [OP_DELETE, OP_INSERT]
    assert np.array_equal(records[0][1], seed)
    wal.append(OP_INSERT, np.asarray([9], np.uint64))
    records, _, _ = WriteAheadLog.replay(path)
    assert [op for op, _ in records] == [OP_DELETE, OP_INSERT, OP_INSERT]
    wal.close()


def test_service_wal_rotation_bounds_replay(rng, tmp_path):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      wal_rotate_bytes=2_000, device=CPU)
    svc.save(tmp_path, fsync=False)
    wal_path = tmp_path / wal_name(0)
    churn = rng.integers(0, 1 << 62, 40, dtype=np.uint64)
    for _ in range(30):
        svc.insert(churn)
        svc.delete(churn)
    assert svc.stats.wal_rotations > 0
    assert wal_path.stat().st_size <= 2_000 + (9 + churn.size * 8) * 2
    live = rng.integers(0, 1 << 62, 120, dtype=np.uint64)
    svc.insert(live)
    model = svc.logical_keys()
    svc.close()
    back = PlexService.open(tmp_path, block=BLOCK, fsync=False, device=CPU)
    assert np.array_equal(back.logical_keys(), model)
    q, want = _queries(rng, model)
    assert np.array_equal(back.lookup(q), want)
    back.close()


def test_crash_during_wal_rotation_keeps_old_segment(rng, tmp_path, caplog):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      wal_rotate_bytes=0, device=CPU)
    svc.save(tmp_path, fsync=False)
    svc.insert(rng.integers(0, 1 << 62, 60, dtype=np.uint64))
    model = svc.logical_keys()
    svc.close()
    wal_path = tmp_path / wal_name(0)
    (tmp_path / (wal_name(0) + ".rot")).write_bytes(b"PLEXWAL1\x01\x02")
    with open(wal_path, "ab") as f:
        f.write(b"\x77" * 5)
    with caplog.at_level(logging.WARNING):
        back = PlexService.open(tmp_path, block=BLOCK, fsync=False,
                                device=CPU)
    assert np.array_equal(back.logical_keys(), model)
    q, want = _queries(rng, model)
    assert np.array_equal(back.lookup(q), want)
    assert not (tmp_path / (wal_name(0) + ".rot")).exists()
    assert any("rotation temp" in r.message for r in caplog.records)
    back.close()


def test_reopen_after_rotation_keeps_rotating(rng, tmp_path):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      wal_rotate_bytes=1_500, device=CPU)
    svc.save(tmp_path, fsync=False)
    churn = rng.integers(0, 1 << 62, 30, dtype=np.uint64)
    for _ in range(10):
        svc.insert(churn)
        svc.delete(churn)
    assert svc.stats.wal_rotations > 0
    model = svc.logical_keys()
    svc.close()
    back = PlexService.open(tmp_path, block=BLOCK, fsync=False,
                            wal_rotate_bytes=1_500, device=CPU)
    assert np.array_equal(back.logical_keys(), model)
    for _ in range(10):
        back.insert(churn)
        back.delete(churn)
    assert back.stats.wal_rotations > 0
    assert (tmp_path / wal_name(0)).stat().st_size < 10 * 2 * (9 + 30 * 8)
    back.close()


# ------------------------------------------------- service save/open ----

@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_roundtrip_parity_all_backends(rng, tmp_path, backend):
    """build -> mutate -> save -> open: merged lookups over the reopened
    service equal searchsorted over the logical key array, the live delta
    replayed from the WAL, on every backend (``cuda`` is its plain version
    here: the tensors are on the CPU)."""
    svc, model = _mutated_service(rng)
    pending = svc.n_pending
    assert pending > 0
    svc.save(tmp_path)
    svc.close()
    back = PlexService.open(tmp_path, backend=backend, block=BLOCK,
                            device=CPU)
    assert back.n_pending == pending
    assert np.array_equal(back.logical_keys(), model)
    q, want = _queries(rng, model)
    assert np.array_equal(back.lookup(q, backend=backend), want)
    assert back.stats.fallback_lookups == 0
    back.close()


def test_wal_replay_reconstructs_exact_delta_state(rng, tmp_path):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      device=CPU)
    svc.insert(np.asarray([keys[10], keys[10] + 1], np.uint64))
    svc.delete(np.asarray([keys[10], keys[20]], np.uint64))
    svc.insert(np.asarray([keys[10]], np.uint64))   # live again
    want = svc._state.delta._state
    svc.save(tmp_path)
    svc.close()
    back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    got = back._state.delta._state
    for field in ("ins", "del_keys", "del_counts", "keys", "weights",
                  "cum0"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            field
    back.close()


def test_open_recovers_torn_wal_tail(rng, tmp_path, caplog):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      device=CPU)
    svc.save(tmp_path)
    ins_a = rng.integers(0, 1 << 62, 50, dtype=np.uint64)
    ins_b = rng.integers(0, 1 << 62, 50, dtype=np.uint64)
    svc.insert(ins_a)
    last = svc.insert(ins_b) and svc._dur.wal.size_bytes
    svc.close()
    wal_path = tmp_path / wal_name(0)
    data = wal_path.read_bytes()
    wal_path.write_bytes(data[:last - (9 + 50 * 8) // 2])
    with caplog.at_level(logging.WARNING):
        back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert any("discarded" in r.message for r in caplog.records)
    model = np.sort(np.concatenate([keys, ins_a]))
    assert np.array_equal(back.logical_keys(), model)
    assert wal_path.stat().st_size == last - (9 + 50 * 8)
    back.insert(ins_b)
    back.close()
    again = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert np.array_equal(again.logical_keys(),
                          np.sort(np.concatenate([model, ins_b])))
    again.close()


def test_open_recovers_corrupt_wal_magic(rng, tmp_path, caplog):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      device=CPU)
    svc.save(tmp_path)
    svc.insert(rng.integers(0, 1 << 62, 20, dtype=np.uint64))  # lost below
    svc.close()
    wal_path = tmp_path / wal_name(0)
    data = bytearray(wal_path.read_bytes())
    data[3] ^= 0xFF
    wal_path.write_bytes(bytes(data))
    with caplog.at_level(logging.WARNING):
        back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert any("invalid header" in r.message for r in caplog.records)
    assert np.array_equal(back.logical_keys(), keys)
    ins = rng.integers(0, 1 << 62, 30, dtype=np.uint64)
    back.insert(ins)
    back.close()
    again = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert np.array_equal(again.logical_keys(),
                          np.sort(np.concatenate([keys, ins])))
    again.close()


def test_open_discards_uncommitted_generation(rng, tmp_path, caplog):
    svc, model = _mutated_service(rng, n=10_000)
    svc.save(tmp_path)
    svc.close()
    assert read_manifest(tmp_path).generation == 0
    half = tmp_path / gen_name(1)
    half.mkdir()
    full = (tmp_path / gen_name(0) / SNAPSHOT_FILE).read_bytes()
    (half / SNAPSHOT_FILE).write_bytes(full[:len(full) // 3])
    (tmp_path / wal_name(1)).write_bytes(b"garbage")
    with caplog.at_level(logging.WARNING):
        back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    msgs = [r.message for r in caplog.records]
    assert any("uncommitted generation" in m for m in msgs)
    assert any("stray WAL" in m for m in msgs)
    assert back.generation == 0
    assert np.array_equal(back.logical_keys(), model)
    q, want = _queries(rng, model, 2_000, 200)
    assert np.array_equal(back.lookup(q, backend="torch"), want)
    back.close()


def test_durable_merge_rotates_generation_and_gc(rng, tmp_path):
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=64,
                      device=CPU)
    svc.save(tmp_path)
    assert svc.durable and svc.generation == 0
    ins = rng.integers(0, 1 << 62, 100, dtype=np.uint64)
    svc.insert(ins)                      # past threshold -> merge -> rotate
    assert svc.stats.merges == 1 and svc.generation == 1
    assert svc.n_pending == 0
    assert read_manifest(tmp_path).generation == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [MANIFEST_NAME, gen_name(1), wal_name(1)]
    svc.close()
    model = np.sort(np.concatenate([keys, ins]))
    back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert np.array_equal(back.logical_keys(), model)
    assert back.snapshot.epoch == 1
    back.close()


def test_background_merge_commits_with_residual(rng, tmp_path):
    """A background merge's durable commit seeds the next generation's WAL
    with the residual journal: updates accepted while it rebuilt survive
    a reopen (lock order ``_merge_mutex`` -> ``_lock``)."""
    keys = sorted_u64(rng, 10_000)
    svc = PlexService(keys.copy(), eps=16, block=BLOCK, merge_threshold=0,
                      merge_mode="background", device=CPU)
    svc.save(tmp_path, fsync=False)
    svc.insert(rng.integers(0, 1 << 62, 80, dtype=np.uint64))
    late = rng.integers(0, 1 << 62, 20, dtype=np.uint64)
    orig = svc._warm

    def warm_then_update(state, backend=None):
        orig(state, backend)
        svc.insert(late)                 # lands in the op journal
    svc._warm = warm_then_update
    assert svc.merge()
    svc._warm = orig
    assert svc.generation == 1 and svc.n_pending == late.size
    model = svc.logical_keys()
    svc.close()
    back = PlexService.open(tmp_path, block=BLOCK, fsync=False, device=CPU)
    assert np.array_equal(back.logical_keys(), model)
    back.close()


def test_save_twice_commits_fresh_generation(rng, tmp_path):
    svc, model = _mutated_service(rng, n=10_000)
    svc.save(tmp_path)
    svc.insert(np.asarray([123456789], np.uint64))
    svc.save(tmp_path)
    assert svc.generation == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [MANIFEST_NAME, gen_name(1), wal_name(1)]
    svc.close()
    back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert np.array_equal(
        back.logical_keys(),
        np.sort(np.concatenate([model, [np.uint64(123456789)]])))
    back.close()


def test_open_missing_manifest_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        PlexService.open(tmp_path / "empty", device=CPU)


def test_absent_key_dup_window_agrees_after_reopen(rng, tmp_path):
    """In duplicate runs wider than eps the absent-key answer may deviate
    from searchsorted, but a persisted and reopened index agrees with the
    freshly built one bit for bit on every backend (present keys stay
    exact everywhere)."""
    base = np.unique(sorted_u64(rng, 4_000))
    run_key = base[1_000]
    keys = np.sort(np.concatenate([base, np.full(600, run_key, np.uint64)]))
    fresh = PlexService(keys.copy(), eps=8, block=BLOCK, merge_threshold=0,
                        device=CPU)
    fresh.save(tmp_path)
    back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    probes = np.asarray([run_key - 2, run_key - 1, run_key, run_key + 1,
                         run_key + 2], np.uint64)
    q = np.concatenate([keys[rng.integers(0, keys.size, 2_000)], probes,
                        rng.integers(0, 1 << 62, 200, dtype=np.uint64)])
    present = np.isin(q, keys)
    want = np.searchsorted(keys, q, side="left")
    for be in ("numpy", "torch", "cuda"):
        got_fresh = fresh.lookup(q, backend=be)
        got_back = back.lookup(q, backend=be)
        assert np.array_equal(got_back, got_fresh), be
        assert np.array_equal(got_back[present], want[present]), be
    fresh.close()
    back.close()


def test_open_reports_load_s_and_keeps_build_s(rng, tmp_path):
    """The reopened service reports its load time and carries the
    original build time (the chip run compares the two at 200M keys)."""
    keys = sorted_u64(rng, 100_000)
    svc = PlexService(keys.copy(), eps=64, block=BLOCK, device=CPU)
    svc.save(tmp_path)
    svc.close()
    back = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert back.load_s > 0.0
    assert back.build_s == pytest.approx(svc.build_s)
    q = keys[rng.integers(0, keys.size, 5_000)]
    assert np.array_equal(back.lookup(q), np.searchsorted(keys, q, "left"))
    back.close()


# ------------------------------------------------ across the packages ----

def _case_keys(case):
    rng = np.random.default_rng(4)
    if case == "radix":
        return generate("amzn", 60_000, 0), 3
    if case == "cht":
        return generate("face", 100_000, 0), 2
    # one shard whose keys are all equal: a one-point spline (R4)
    keys = np.sort(np.concatenate([
        np.arange(3000, dtype=np.uint64), np.full(3000, 5000, np.uint64),
        np.unique(rng.integers(6000, 1 << 60, 3200, dtype=np.uint64))[:3000]]))
    return keys, 3


def _kinds(shards):
    return {type(getattr(px, "plex", px).layer).__name__ for px in shards}


def _one_point(snap):
    """Per shard: whether its spline has one point."""
    return np.asarray([getattr(px, "plex", px).spline.keys.size == 1
                       for px in snap.shards])


def _mutate(svc, keys, rng):
    ins = np.concatenate([rng.integers(keys[0], keys[-1], 300,
                                       dtype=np.uint64),
                          keys[rng.integers(0, keys.size, 30)]])
    dels = keys[rng.integers(0, keys.size, 100)]
    svc.insert(ins)
    svc.delete(dels)
    svc.insert(dels[:5])


def _cross_queries(logical, keys, rng):
    """Present keys, the snapshot's keys (some deleted since) and absent
    keys inside the key range (past the end of a narrow radix shard the
    reference's prefix wraps, R5)."""
    return np.concatenate([
        logical[rng.integers(0, logical.size, 2_000)], keys[::97],
        rng.integers(logical[0], logical[-1], 400, dtype=np.uint64)])


CASES = ["radix", "cht", "one_point"]


@pytest.mark.parametrize("case", CASES)
def test_port_opens_reference_generation(case, tmp_path):
    """A reference-written generation, its WAL holding a live delta, opened
    by the port serves the reference's ranks (and, on a one-point-spline
    shard, where the reference's device path gathers out of its row (R4),
    searchsorted's)."""
    rng = np.random.default_rng(11)
    keys, shards = _case_keys(case)
    ref = RService(keys.copy(), eps=8, n_shards=shards, block=BLOCK,
                   backend="jnp", merge_threshold=0)
    _mutate(ref, keys, rng)
    ref.save(tmp_path)
    logical = ref.logical_keys()
    q = _cross_queries(logical, keys, rng)
    want = ref.lookup(q)
    ref_snap = ref._state.snapshot
    ref.close()
    port = PlexService.open(tmp_path, block=BLOCK, device=CPU)
    assert port.n_pending > 0
    assert np.array_equal(port.logical_keys(), logical)
    if case == "cht":
        assert "CHT" in _kinds(port.snapshot.shards)
    got = port.lookup(q)
    present = np.isin(q, logical)
    assert np.array_equal(got[present],
                          np.searchsorted(logical, q[present], "left"))
    r4 = _one_point(ref_snap)[ref_snap.route(q)]
    assert (case == "one_point") == bool(r4.any())
    assert np.array_equal(got[~r4], want[~r4])
    assert np.array_equal(got[r4], np.searchsorted(logical, q[r4], "left"))
    for be in ("torch", "numpy"):
        assert np.array_equal(port.lookup(q[present], backend=be),
                              got[present]), be
    port.close()


@pytest.mark.parametrize("case", CASES)
def test_reference_opens_port_generation(case, tmp_path):
    """A port-written generation opened by the reference's
    ``PlexService.open(backend="jnp")`` serves the port's ranks (where the
    reference's device path is right: off a one-point-spline shard, R4)."""
    rng = np.random.default_rng(12)
    keys, shards = _case_keys(case)
    port = PlexService(keys.copy(), eps=8, n_shards=shards, block=BLOCK,
                       merge_threshold=0, device=CPU)
    _mutate(port, keys, rng)
    port.save(tmp_path)
    logical = port.logical_keys()
    q = _cross_queries(logical, keys, rng)
    want = port.lookup(q)
    port.close()
    assert RF.validate_snapshot(tmp_path / gen_name(0))
    assert RM.read_manifest(tmp_path).generation == 0
    ref = RService.open(tmp_path, backend="jnp", block=BLOCK)
    assert np.array_equal(ref.logical_keys(), logical)
    got = ref.lookup(q)
    snap = ref._state.snapshot
    r4 = _one_point(snap)[snap.route(q)]
    assert (case == "one_point") == bool(r4.any())
    assert np.array_equal(got[~r4], want[~r4])
    ref.close()


@pytest.mark.parametrize("case", CASES)
def test_files_are_byte_identical(case, tmp_path):
    """For the same snapshot (the port's built from the reference's arrays
    by ``convert.snapshot_from_arrays``, ``build_s`` and ``epoch`` pinned)
    the snapshot files are equal byte for byte; so are the manifests and,
    for the same op sequence, the WAL segments — appended record by record
    and seeded by a service's ``save``."""
    rng = np.random.default_rng(13)
    keys, shards = _case_keys(case)
    rsnap = RSnap.build(keys.copy(), 8, n_shards=shards)
    tsnap = snapshot_from_arrays(*_arrays(rsnap), eps=8, device=CPU)
    for snap in (rsnap, tsnap):
        snap.build_s, snap.epoch = 1.25, 3
    rsnap.save(tmp_path / "r")
    tsnap.save(tmp_path / "t")
    r_bytes = (tmp_path / "r" / SNAPSHOT_FILE).read_bytes()
    t_bytes = (tmp_path / "t" / SNAPSHOT_FILE).read_bytes()
    assert r_bytes == t_bytes
    if case == "one_point":
        assert _one_point(tsnap).any()
    hlen = int.from_bytes(t_bytes[8:16], "little")
    header = json.loads(t_bytes[24:24 + hlen])
    radix = [sh["static"] for sh in header["shards"] if sh["kind"] == "radix"]
    assert all(list(s) == ["shift", "r", "min_hi", "min_lo", "max_win",
                           "mode"] for s in radix)
    RM.write_manifest(tmp_path / "r", RM.Manifest.for_generation(7))
    write_manifest(tmp_path / "t", Manifest.for_generation(7))
    assert (tmp_path / "r" / MANIFEST_NAME).read_bytes() == \
        (tmp_path / "t" / MANIFEST_NAME).read_bytes()
    ops = [(OP_INSERT, rng.integers(0, 1 << 63, 17, dtype=np.uint64)),
           (OP_DELETE, keys[rng.integers(0, keys.size, 5)]),
           (OP_INSERT, np.zeros(0, np.uint64))]
    rw = RW.WriteAheadLog.create(tmp_path / "r.log", fsync=False)
    tw = WriteAheadLog.create(tmp_path / "t.log", fsync=False)
    for op, k in ops:
        assert rw.append(op, k) == tw.append(op, k)
    rw = rw.rotate(ops[:2])
    tw = tw.rotate(ops[:2])
    rw.close()
    tw.close()
    assert (tmp_path / "r.log").read_bytes() == \
        (tmp_path / "t.log").read_bytes()
    # the services' seeded WALs for the same op sequence
    ref = RService(keys.copy(), eps=8, n_shards=shards, block=BLOCK,
                   backend="jnp", merge_threshold=0)
    port = PlexService(keys.copy(), eps=8, n_shards=shards, block=BLOCK,
                       merge_threshold=0, device=CPU)
    for svc in (ref, port):
        _mutate(svc, keys, np.random.default_rng(14))
    ref.save(tmp_path / "rs", fsync=False)
    port.save(tmp_path / "ts", fsync=False)
    for name in (MANIFEST_NAME, wal_name(0)):
        assert (tmp_path / "rs" / name).read_bytes() == \
            (tmp_path / "ts" / name).read_bytes(), name
    ref.close()
    port.close()


@pytest.mark.gpu
def test_open_serves_through_k1_on_card(tmp_path):
    """On a CUDA card: a reopened service answers through K1 (launches
    counted, no fallback), every rank equal to searchsorted
    (``python3 chip_smoke.py``'s ``durable`` phase does the same at 200M
    keys)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(15)
    keys = generate("osm", 2_000_000, 0)
    svc = PlexService(keys.copy(), eps=64, block=1 << 14, device="cuda")
    svc.save(tmp_path)
    _mutate(svc, keys, rng)
    logical = svc.logical_keys()
    del svc
    back = PlexService.open(tmp_path, block=1 << 14, device="cuda")
    assert np.array_equal(back.logical_keys(), logical)
    q = _cross_queries(logical, keys, rng)
    SL.launches = 0
    got = back.lookup(q)
    assert SL.launches > 0 and back.stats.fallback_lookups == 0
    assert np.array_equal(got, np.searchsorted(logical, q, "left"))
    back.close()
