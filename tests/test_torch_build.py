"""Port host build against the reference, plus the port's import and device
guards.

The same keys (``repro.data.generate`` and the port's copy give the same
arrays) go through ``repro.core`` and ``repro_torch.core``; spline points,
layer arrays, tuning and shard offsets must be identical.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.kernels.stacked_lookup import StackedTorchPlex
from repro_torch.serving import PlexService

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _assert_layer_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(b, R.RadixTable):
        assert (a.r, a.shift, a.n_keys) == (b.r, b.shift, b.n_keys)
        assert a.min_key == b.min_key
        assert np.array_equal(a.table, b.table)
    else:
        assert (a.r, a.delta, a.n_nodes, a.max_depth, a.n_keys) == \
            (b.r, b.delta, b.n_nodes, b.max_depth, b.n_keys)
        assert np.array_equal(a.cells, b.cells)


def _assert_tuning_equal(a, b):
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _assert_plex_equal(a, b):
    assert np.array_equal(a.spline.keys, b.spline.keys)
    assert np.array_equal(a.spline.positions, b.spline.positions)
    assert (a.eps, a.spline.n_keys) == (b.eps, b.spline.n_keys)
    assert np.array_equal(a.keys, b.keys)
    _assert_layer_equal(a.layer, b.layer)
    _assert_tuning_equal(a.tuning, b.tuning)


@pytest.mark.parametrize("name", ["amzn", "face", "osm", "wiki"])
def test_generators_identical(name):
    for n, seed in ((1_000, 0), (20_000, 3)):
        assert np.array_equal(TD.generate(name, n, seed),
                              RD.generate(name, n, seed))


@pytest.mark.parametrize("name", ["amzn", "face", "osm", "wiki"])
@pytest.mark.parametrize("eps", [8, 64])
def test_build_plex_identical(name, eps):
    keys = RD.generate(name, 30_000, 1)
    _assert_plex_equal(T.build_plex(keys, eps), R.build_plex(keys, eps))


@pytest.mark.parametrize("name", ["face", "wiki"])
def test_snapshot_shards_identical(name):
    """Shard offsets (snapped to first occurrences: wiki has duplicates) and
    every shard's index."""
    keys = RD.generate(name, 60_000, 2)
    ref = R.Snapshot.build(keys.copy(), 32, n_shards=3)
    got = T.Snapshot.build(keys.copy(), 32, n_shards=3, device="cpu")
    assert np.array_equal(got.offsets, ref.offsets)
    assert np.array_equal(got.shard_min, ref.shard_min)
    for a, b in zip(got.shards, ref.shards):
        _assert_plex_equal(a, b.plex)
    q = np.concatenate([keys[::97], np.asarray([0, (1 << 64) - 1],
                                               np.uint64)])
    assert np.array_equal(got.route(q), ref.route(q))


def test_cht_and_radix_layers_identical(rng):
    sk = np.unique(rng.integers(0, 1 << 62, 5_000, dtype=np.uint64))
    for r, delta in ((3, 8), (6, 16), (8, 1)):
        _assert_layer_equal(T.build_cht(sk, r, delta), R.build_cht(sk, r, delta))
    for r in (1, 8, 20):
        _assert_layer_equal(T.build_radix_table(sk, r),
                            R.build_radix_table(sk, r))
    assert np.array_equal(T.adjacent_lcp(sk), R.adjacent_lcp(sk))


def test_helpers_identical(rng):
    x = np.concatenate([rng.integers(0, np.iinfo(np.uint64).max, 500,
                                     dtype=np.uint64, endpoint=True),
                        np.asarray([0, 1, (1 << 64) - 1], np.uint64)])
    from repro.core.cht import _extract_bins as r_bins, bit_length_u64
    from repro.core.radix_table import range_bits
    from repro_torch.core.cht import _extract_bins as t_bins
    assert np.array_equal(T.bit_length_u64(x), bit_length_u64(x))
    for off, r in ((0, 4), (8, 8), (60, 4), (33, 16)):
        assert np.array_equal(t_bins(x, off, r), r_bins(x, off, r))
    sx = np.sort(x)
    assert T.range_bits(sx) == range_bits(sx)
    keys = np.sort(x)
    lo = rng.integers(0, keys.size - 40, 300)
    hi = lo + rng.integers(0, 40, 300)
    q = keys[rng.integers(0, keys.size, 300)]
    for side in ("left", "right"):
        assert np.array_equal(
            T.bounded_lower_bound(keys, q, lo, hi, side=side),
            R.bounded_lower_bound(keys, q, lo, hi, side=side))


def test_cost_models_identical(rng):
    keys = RD.generate("osm", 20_000, 0)
    sp = R.build_spline(keys, 16)
    a = T.radix_cost_model(sp.keys, keys, 12)
    b = R.radix_cost_model(sp.keys, keys, 12)
    assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2]))
    assert a[2] == b[2]
    for x, y in zip(T.cht_cost_model(sp.keys, 8, 64),
                    R.cht_cost_model(sp.keys, 8, 64)):
        assert np.array_equal(x, y)


# ------------------------------------------------------------- guards ----

def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod, level in _imported_modules(f):
            if level:
                continue                  # relative: inside repro_torch
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


@pytest.mark.parametrize("entry", ["service", "snapshot", "stacked"])
def test_default_device_raises_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(1_000, dtype=np.uint64) * np.uint64(7)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "service":
            PlexService(keys, eps=16)
        elif entry == "snapshot":
            T.Snapshot.build(keys, 16)
        else:
            StackedTorchPlex.from_plexes([T.build_plex(keys, 16)],
                                         np.zeros(1, np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        PlexService(keys, eps=16, device="cuda")
