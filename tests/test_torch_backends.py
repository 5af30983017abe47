"""The port's backend registry: the counterparts of the registry tests of
``tests/test_stacked_pallas.py`` (the unknown-backend error, a custom
backend on every surface, the duplicate guard, host backends without a
stacked path), and the built-ins ``numpy``, ``torch`` and ``cuda`` held to
one another and to the reference's ``jnp`` on the same seeded inputs.

On the CPU the ``cuda`` backend runs its kernels' plain versions (the
tensors lie on the CPU); ``torch`` asks for the plain versions on any
device, so its impls carry ``plain``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import LearnedIndex as RIndex
from repro_torch.convert import plex_from_arrays
from repro_torch.core import LearnedIndex, Snapshot
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.backends import (BACKENDS, backend_names,
                                          get_backend, register_backend,
                                          unregister_backend)
from repro_torch.kernels.ops import DevicePlex
from repro_torch.kernels.stacked_lookup import StackedTorchPlex
from repro_torch.resilience import FAULTS, fail_once
from repro_torch.resilience.faults import (POINT_BACKEND_DISPATCH,
                                           POINT_BACKEND_FACTORY)
from repro_torch.serving import PlexService

from conftest import sorted_u64

BLOCK = 512


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def test_unknown_backend_lists_registered():
    with pytest.raises(ValueError, match="registered backends"):
        get_backend("pallas")
    keys = np.arange(1, 2_000, dtype=np.uint64)
    with pytest.raises(ValueError, match="registered backends"):
        LearnedIndex.build(keys, eps=16, backend="nope", device="cpu")
    with pytest.raises(ValueError, match="registered backends"):
        PlexService(keys, eps=16, backend="nope", device="cpu")
    idx = LearnedIndex.build(keys, eps=16, device="cpu")
    with pytest.raises(ValueError, match="registered backends"):
        idx.lookup(keys[:10], backend="nope")


def test_custom_backend_plugs_into_every_surface(rng):
    """A third-party registration is reachable from LearnedIndex dispatch,
    Snapshot stacked builds and PlexService serving with no string branch
    outside the registry."""
    calls = {"stacked": 0, "index": 0}

    def stacked_factory(plexes, row_off, **kw):
        calls["stacked"] += 1
        return StackedTorchPlex.from_plexes(plexes, row_off,
                                            device=kw["device"],
                                            block=kw["block"],
                                            probe=kw.get("probe"))

    def index_factory(px, *, block, device):
        calls["index"] += 1
        return px

    register_backend("custom-test", stacked_factory,
                     index_factory=index_factory)
    try:
        assert "custom-test" in backend_names()
        keys = sorted_u64(rng, 10_000)
        q = keys[rng.integers(0, keys.size, 1_000)]
        want = np.searchsorted(keys, q, side="left")
        idx = LearnedIndex.build(keys, eps=16, backend="custom-test",
                                 device="cpu")
        assert np.array_equal(idx.lookup(q), want)
        assert calls["index"] == 1
        svc = PlexService(keys, eps=16, n_shards=2, block=BLOCK,
                          backend="custom-test", device="cpu")
        assert np.array_equal(svc.lookup(q), want)
        assert calls["stacked"] >= 1
        assert svc.health()["fallback_chain"] == ["custom-test", "torch",
                                                  "numpy"]
        snap = Snapshot.build(keys, eps=16, n_shards=2, device="cpu")
        st = snap.stacked_impl("custom-test", block=BLOCK)
        assert isinstance(st, StackedTorchPlex) and not st.plain
    finally:
        unregister_backend("custom-test")
    with pytest.raises(ValueError):
        get_backend("custom-test")


def test_duplicate_registration_guard():
    with pytest.raises(ValueError, match="already registered"):
        register_backend("cuda", None)


def test_host_backend_has_no_stacked_path(rng):
    keys = sorted_u64(rng, 5_000)
    idx = LearnedIndex.build(keys, eps=16, device="cpu")
    with pytest.raises(ValueError, match="no stacked device path"):
        idx.stacked_impl("numpy")
    snap = Snapshot.build(keys, eps=16, device="cpu")
    with pytest.raises(ValueError, match="no stacked device path"):
        snap.stacked_impl("numpy")
    with pytest.raises(ValueError, match="no stacked device path"):
        snap.shard_impl(0, "numpy")


def test_builtins_agree_with_the_reference(rng):
    """``numpy``, ``torch`` and ``cuda`` answer a LearnedIndex, a snapshot's
    fused path and a service identically, and as the reference's ``jnp``
    does; ``torch``'s impls ask for the plain versions, ``cuda``'s do
    not."""
    assert BACKENDS == ("numpy", "torch", "cuda") == backend_names()
    assert get_backend("numpy").host and not get_backend("numpy").stacked
    keys = sorted_u64(rng, 30_000, dups=True)
    q = np.concatenate([keys[rng.integers(0, keys.size, 2_000)],
                        rng.integers(keys[0], keys[-1], 300,
                                     dtype=np.uint64)])
    ref = RIndex.build(keys.copy(), eps=16, backend="jnp")
    want = ref.lookup(q)
    idx = LearnedIndex(plex=ref_plex_to_port(ref), device="cpu")
    assert idx.backend_impl("numpy") is idx.plex
    assert idx.backend_impl("torch").plain
    assert not idx.backend_impl("cuda").plain
    assert isinstance(idx.backend_impl("torch"), DevicePlex)
    for be in ("torch", "cuda"):
        assert np.array_equal(idx.lookup(q, backend=be), want), be
    snap = Snapshot.build(keys.copy(), eps=16, n_shards=3, device="cpu")
    out = {be: snap.stacked_impl(be, block=BLOCK).lookup(q)
           for be in ("torch", "cuda")}
    assert np.array_equal(out["torch"], out["cuda"])
    svc = PlexService(keys.copy(), eps=16, n_shards=3, block=BLOCK,
                      device="cpu")
    got = {be: svc.lookup(q, backend=be) for be in backend_names()}
    assert all(np.array_equal(got[be], got["cuda"]) for be in got)
    present = np.isin(q, keys)
    assert np.array_equal(got["cuda"][present],
                          np.searchsorted(keys, q[present], "left"))
    report = svc.throughput(q[:1_000], repeats=1)
    assert set(report) == set(backend_names())
    assert svc.stats.fallback_lookups == 0


def ref_plex_to_port(ref):
    """The port's PLEX over a reference index's arrays (no rebuild)."""
    px = ref.plex
    layer = dict(kind="radix", table=px.layer.table, shift=px.layer.shift,
                 r=px.layer.r, min_key=px.layer.min_key) \
        if px.layer.__class__.__name__ == "RadixTable" else \
        dict(kind="cht", cells=px.layer.cells, r=px.layer.r,
             delta=px.layer.delta, max_depth=px.layer.max_depth)
    return plex_from_arrays(px.keys, px.spline.keys, px.spline.positions,
                            layer, dataclasses.asdict(px.tuning), px.eps)


def test_torch_route_counts_plain_calls_not_launches(rng):
    """The explicit plain route counts in ``plain_calls``, never in
    ``launches``, and the ``torch`` backend takes it."""
    keys = sorted_u64(rng, 10_000)
    snap = Snapshot.build(keys, eps=16, device="cpu")
    q = keys[::11]
    SL.launches = SL.plain_calls = 0
    snap.stacked_impl("cuda", block=BLOCK).lookup(q)
    assert SL.plain_calls == 0
    st = snap.stacked_impl("torch", block=BLOCK)
    assert np.array_equal(st.lookup(q), np.searchsorted(keys, q, "left"))
    assert SL.plain_calls == -(-q.size // BLOCK) and SL.launches == 0


def test_factory_and_dispatch_points_carry_the_backend(rng):
    keys = sorted_u64(rng, 5_000)
    idx = LearnedIndex.build(keys, eps=16, device="cpu")
    with FAULTS.injected(POINT_BACKEND_FACTORY, fail_once(backend="torch")):
        idx.backend_impl("cuda")                 # no match: builds
        with pytest.raises(RuntimeError, match="backend='torch'"):
            idx.backend_impl("torch")
    with FAULTS.injected(POINT_BACKEND_DISPATCH, fail_once(backend="cuda")):
        with pytest.raises(RuntimeError, match="backend.dispatch"):
            idx.lookup(keys[:10])
    assert np.array_equal(idx.lookup(keys[:10]),
                          np.searchsorted(keys, keys[:10], "left"))
    assert idx.backend_impl("numpy") is idx.plex   # never instrumented
    assert not hasattr(idx.plex.lookup, "__wrapped__")


def test_backends_share_one_copy_of_the_planes(rng, tmp_path):
    """The ``cuda`` and ``torch`` impls of one snapshot differ only in
    their route: fused and per shard they hold the same device planes,
    built once, and a loaded snapshot reads its mapped file once a shard
    range; each impl keeps a cache of its own."""
    keys = sorted_u64(rng, 20_000)
    q = keys[rng.integers(0, keys.size, 2_000)]
    want = np.searchsorted(keys, q, "left")
    Snapshot.build(keys, eps=16, n_shards=2, device="cpu").save(tmp_path)
    snap = Snapshot.load(tmp_path, device="cpu")
    reads = []
    fn = snap._host_planes_fn
    snap._host_planes_fn = lambda *a: reads.append(a) or fn(*a)
    kern = snap.stacked_impl("cuda", block=BLOCK, cache_slots=1 << 10)
    plain = snap.stacked_impl("torch", block=BLOCK, cache_slots=1 << 10)
    assert plain.planes is kern.planes and plain.plain and not kern.plain
    assert plain._cache is not kern._cache
    assert snap.stacked_impl("cuda", block=BLOCK).planes is kern.planes
    one = snap.shard_impl(1, "cuda", block=BLOCK)
    assert snap.shard_impl(1, "torch", block=BLOCK).planes is one.planes
    assert one.planes is not kern.planes
    assert reads == [(), (1, 2)]
    for st in (kern, plain):
        assert np.array_equal(st.lookup(q), want)


@pytest.mark.gpu
def test_torch_backend_runs_plain_on_card(rng):
    """On a CUDA card: the ``torch`` backend's impl keeps its planes on the
    card and runs the plain pipeline there, equal to K1's answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys = sorted_u64(rng, 1 << 20)
    snap = Snapshot.build(keys, eps=64, n_shards=2, device="cuda")
    q = keys[rng.integers(0, keys.size, 1 << 16)]
    SL.launches = SL.plain_calls = 0
    plain = snap.stacked_impl("torch", block=1 << 14).lookup(q)
    assert SL.launches == 0 and SL.plain_calls > 0
    kern = snap.stacked_impl("cuda", block=1 << 14).lookup(q)
    assert SL.launches > 0
    assert np.array_equal(plain, kern)
    assert np.array_equal(kern, np.searchsorted(keys, q, "left"))
