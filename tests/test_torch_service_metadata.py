"""The port's service and snapshot metadata against the reference's.

``PlexService.keys``, ``offsets``, ``shard_min``, ``shards`` (each shard's
``keys``, ``eps``, ``size_bytes`` and ``name``), ``size_bytes``, ``name`` and
``stacked_impl(state=, backend=)``, and ``Snapshot.size_bytes``, of
``repro_torch`` on ``device="cpu"`` beside ``repro.serving.PlexService`` on
the same keys: on the fused and the per-shard path, as built, after inserts
and deletes, after a merge (a new epoch), after ``save``/``open``, and on a
service routed over three CPU slots.
"""
import numpy as np
import pytest
import torch

from repro.core.index import Snapshot as RSnap
from repro.data import generate
from repro.serving import PlexService as RService
from repro_torch.core import LearnedIndex, Snapshot
from repro_torch.serving import PlexService

CPU = torch.device("cpu")
CASES = {
    # name: (dataset, n, shards, fused?)
    "fused": ("amzn", 60_000, 3, True),
    "per_shard": ("face", 100_000, 2, False),
}
STAGES = ("built", "updated", "merged", "reopened")


def _assert_metadata(port, ref):
    assert port.name == ref.name == "PlexService"
    for attr in ("keys", "offsets", "shard_min"):
        got, want = getattr(port, attr), getattr(ref, attr)
        assert got.dtype == want.dtype and np.array_equal(got, want), attr
    assert port.size_bytes == ref.size_bytes > 0
    assert port.n_shards == ref.n_shards == len(port.shards) \
        == len(ref.shards)
    for i, (s, r) in enumerate(zip(port.shards, ref.shards)):
        assert isinstance(s, LearnedIndex) and s.name == r.name
        assert np.array_equal(s.keys, r.keys), i
        assert s.eps == r.eps and s.size_bytes == r.size_bytes, i
        # the shard's own PLEX, wrapped with no rebuild
        assert s.plex is port.snapshot.shards[i]
    assert sum(s.size_bytes for s in port.shards) == port.size_bytes
    assert port.snapshot.size_bytes == ref._state.snapshot.size_bytes
    assert port.epoch == ref.epoch
    # the fused path exists on both or on neither
    assert (port.stacked_impl() is None) == (ref.stacked_impl() is None)


def _updates(rng, keys):
    ins = rng.integers(keys[0], keys[-1], 400, dtype=np.uint64)
    dels = keys[rng.integers(0, keys.size, 250)]
    return ins, dels


def _drive(svc, stage, rng, keys, root):
    """Take ``svc`` to ``stage``; returns the service to check (a reopened
    one for ``reopened``)."""
    if stage == "built":
        return svc
    ins, dels = _updates(rng, keys)
    svc.insert(ins)
    svc.delete(dels)
    if stage == "updated":
        return svc
    svc.merge()
    if stage == "merged":
        return svc
    svc.insert(ins[:64])
    svc.save(root)
    svc.close()
    opened = type(svc).open(root, **(
        {"device": "cpu"} if isinstance(svc, PlexService) else
        {"backend": "jnp"}))
    return opened


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_service_metadata_matches_reference(case, stage, tmp_path):
    dataset, n, shards, fused = CASES[case]
    keys = generate(dataset, n, 0)
    port = PlexService(keys.copy(), eps=32, n_shards=shards, block=512,
                       merge_threshold=0, device="cpu")
    ref = RService(keys.copy(), eps=32, n_shards=shards, block=512,
                   merge_threshold=0, backend="jnp")
    assert port.fused is fused
    port = _drive(port, stage, np.random.default_rng(3), keys,
                  tmp_path / "port")
    ref = _drive(ref, stage, np.random.default_rng(3), keys,
                 tmp_path / "ref")
    try:
        if stage in ("merged", "reopened"):
            assert port.epoch == ref.epoch == 1
        _assert_metadata(port, ref)
        # the metadata is the snapshot's; pending updates are not in it
        assert port.n_pending == ref.n_pending
        assert np.array_equal(port.logical_keys(), ref.logical_keys())
    finally:
        port.close()
        ref.close()


def test_stacked_impl_follows_the_captured_state():
    """``stacked_impl()`` is the current snapshot's fused impl on the
    service's default backend (the one lookups launch); a caller that
    captured a state before a merge keeps that snapshot's impl; ``backend=``
    picks another backend's impl over the same planes."""
    keys = generate("amzn", 60_000, 0)
    svc = PlexService(keys.copy(), eps=32, n_shards=3, block=512,
                      merge_threshold=0, device="cpu")
    try:
        before = svc._state
        st = svc.stacked_impl()
        assert st is not None and st is before.stacked
        assert svc.stacked_impl(state=before) is st
        plain = svc.stacked_impl(backend="torch")
        assert plain is not st and plain.plain and plain.planes is st.planes
        svc.insert(np.arange(1, 300, dtype=np.uint64) + keys[0])
        svc.merge()
        assert svc.epoch == 1
        assert svc.stacked_impl() is svc._state.stacked is not st
        assert svc.stacked_impl(state=before) is st
        with pytest.raises(ValueError):
            svc.stacked_impl(backend="numpy")      # no device path
    finally:
        svc.close()


def test_metadata_on_a_routed_service():
    """A service routed over three CPU slots reports the whole snapshot's
    metadata, through inserts, deletes and a merge that re-plans."""
    keys = np.unique(generate("osm", 60_000, 0))
    port = PlexService(keys.copy(), eps=32, n_shards=6, block=512,
                       merge_threshold=0, device=CPU, backend="torch",
                       devices=[CPU] * 3, plan=3)
    ref = RService(keys.copy(), eps=32, n_shards=6, block=512,
                   merge_threshold=0, backend="jnp")
    try:
        assert port.plan is not None and port.plan.n_devices == 3
        _assert_metadata(port, ref)
        rng = np.random.default_rng(5)
        ins, dels = _updates(rng, keys)
        for svc in (port, ref):
            svc.insert(ins)
            svc.delete(dels)
        _assert_metadata(port, ref)
        port.merge()
        ref.merge()
        assert port.plan is not None
        _assert_metadata(port, ref)
        q = port.logical_keys()[::37]
        assert np.array_equal(port.lookup(q), ref.lookup(q))
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("dataset", ("amzn", "face", "osm", "wiki"))
def test_snapshot_size_bytes(dataset):
    keys = generate(dataset, 40_000, 1)
    snap = Snapshot.build(keys.copy(), 32, n_shards=3, device="cpu")
    ref = RSnap.build(keys.copy(), 32, n_shards=3)
    assert snap.name == ref.name == "Snapshot"
    assert snap.size_bytes == ref.size_bytes == sum(
        px.size_bytes for px in snap.shards)
    assert [i.size_bytes for i in snap.indexes] == \
        [s.size_bytes for s in ref.shards]
    assert snap.indexes is snap.indexes          # wrapped once
