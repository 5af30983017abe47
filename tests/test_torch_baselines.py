"""The port's baselines (``repro_torch.core.baselines``) against the
reference's (``repro.core.baselines``) and ``np.searchsorted``.

The counterparts of ``tests/test_plex.py``'s baseline tests on the same
keys; then parity with the reference: the same built arrays, the same
``size_bytes``, the same ranks wherever the reference answers the lower
bound (every present key of the four datasets), the same predictions bit
for bit below 2^53; and ``np.searchsorted`` where the reference's is wrong
(ROADMAP queue 3: R1 and R8 above 2^53, R2 past the end, R9 for the RMI's
absent keys, R10 for the PGM's levels above 2^53).
"""
import warnings

import numpy as np
import pytest

import repro.core.baselines as RB
from repro.core import build_plex as r_build_plex
from repro.core.baselines.bsearch import build_binary_search as r_bsearch
from repro.core.baselines.btree import build_btree as r_btree
from repro.core.baselines.cht_index import build_cht_index as r_cht_index
from repro.core.baselines.pgm import build_pgm as r_pgm
from repro.core.baselines.radixspline import build_radixspline as r_rs
from repro.core.baselines.rmi import build_rmi as r_rmi
from repro.core.spline import build_spline as r_build_spline
from repro_torch.core import build_plex
from repro_torch.core.baselines import (BTree, BinarySearch, CHTIndex,
                                        DuplicateKeysError, PGMIndex, RMI,
                                        RadixSpline, build_binary_search,
                                        build_btree, build_cht_index,
                                        build_pgm, build_radixspline,
                                        build_rmi)
from repro_torch.data import generate

DATASETS = ("amzn", "face", "osm", "wiki")
U64_MAX = (1 << 64) - 1

# (name, port builder, reference builder) at tests/test_plex.py's settings
BUILDERS = (
    ("RadixSpline", lambda k: build_radixspline(k, eps=16),
     lambda k: r_rs(k, eps=16)),
    ("PGM", lambda k: build_pgm(k, eps=16), lambda k: r_pgm(k, eps=16)),
    ("RMI", lambda k: build_rmi(k, n_models=2048),
     lambda k: r_rmi(k, n_models=2048)),
    ("BTree", build_btree, r_btree),
    ("BinarySearch", build_binary_search, r_bsearch),
    ("CHT", build_cht_index, r_cht_index),
)
NAMES = [b[0] for b in BUILDERS]


def _builder(name):
    return next(b for b in BUILDERS if b[0] == name)


def _queries(keys, rng):
    """Present keys, absent ones inside the key range, keys past the end
    (up to 2^64 - 1) and keys below the first."""
    present = keys[rng.integers(0, keys.size, 10_000)]
    absent = rng.integers(keys[0], keys[-1], 10_000, dtype=np.uint64)
    last = int(keys[-1])
    past = np.asarray([min(last + d, U64_MAX) for d in (1, 7, 1 << 20)]
                      + [U64_MAX], dtype=np.uint64)
    below = np.asarray([0, max(int(keys[0]) - 1, 0)], dtype=np.uint64)
    return present, np.concatenate([absent, past, below])


def _unique_if_needed(name, keys):
    # the CHT index refuses duplicates (face and wiki have them)
    return np.unique(keys) if name == "CHT" else keys


def _ref_lookup(idx, q):
    # the reference's int64 casts overflow past the end (R2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return idx.lookup(q)


# -- tests/test_plex.py's baseline tests, on the port ------------------------

@pytest.mark.parametrize("dataset", DATASETS)
def test_all_indexes_on_datasets(dataset):
    """Every port baseline answers np.searchsorted on present keys, absent
    keys, keys past the end and keys below the first; the port's PLEX on
    present keys (its contract, paper §3) and past the end (R2)."""
    rng = np.random.default_rng(0)
    keys = generate(dataset, 50_000)
    present, other = _queries(keys, rng)
    px = build_plex(keys, eps=16)
    for q in (present, other[-6:]):
        assert np.array_equal(px.lookup(q),
                              np.searchsorted(keys, q, side="left"))
    for name, build, _ in BUILDERS:
        k = _unique_if_needed(name, keys)
        idx = build(k)
        for q in (present, other):
            want = np.searchsorted(k, q, side="left")
            assert np.array_equal(idx.lookup(q), want), (dataset, name)


def test_cht_index_rejects_duplicates():
    wiki = generate("wiki", 30_000)
    assert np.any(wiki[1:] == wiki[:-1]), "wiki synthetic must have dups"
    with pytest.raises(DuplicateKeysError):
        build_cht_index(wiki)
    assert issubclass(DuplicateKeysError, ValueError)
    # ...but PLEX handles the same keys (paper §4 Build Time)
    px = build_plex(wiki, eps=8)
    assert np.array_equal(px.lookup(wiki),
                          np.searchsorted(wiki, wiki, side="left"))


def test_absent_keys_lower_bound():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 2**50, 40_000, dtype=np.uint64))
    q = rng.integers(keys[0], keys[-1], 10_000, dtype=np.uint64)
    want = np.searchsorted(keys, q, side="left")
    px = build_plex(keys, eps=16)
    got = px.lookup(q)
    # in-window absent keys resolve exactly; the contract is positive
    # lookups (paper §3), so allow the eps-window edge for absent ones
    assert (got == want).mean() > 0.999
    assert np.all(np.abs(got - want) <= 2 * px.eps + 2)
    assert np.array_equal(got, r_build_plex(keys, eps=16).lookup(q))
    for name, build, _ in BUILDERS:
        k = _unique_if_needed(name, keys)
        assert np.array_equal(build(k).lookup(q),
                              np.searchsorted(k, q, side="left")), name


def test_size_accounting():
    keys = generate("amzn", 40_000)
    px = build_plex(keys, eps=16)
    assert px.size_bytes == px.spline.size_bytes + px.layer.size_bytes
    assert px.stats.total_s > 0
    rs = build_radixspline(keys, eps=16)
    assert rs.size_bytes == rs.spline.size_bytes + rs.table.size_bytes
    pgm = build_pgm(keys, eps=16)
    assert pgm.size_bytes == sum(lv.size_bytes for lv in pgm.levels)
    rmi = build_rmi(keys, n_models=1024)
    assert rmi.size_bytes == 1024 * 32
    bt = build_btree(keys, fanout=16)
    assert bt.size_bytes == 8 * sum(lv.size for lv in bt.levels)
    assert build_binary_search(keys).size_bytes == 0
    assert build_cht_index(keys).size_bytes == \
        build_cht_index(keys).cht.size_bytes


# -- parity with the reference ----------------------------------------------

def _built_arrays(idx):
    """Every array and static a baseline's lookup reads, by name."""
    if isinstance(idx, (BinarySearch, RB.BinarySearch)):
        return {"keys": idx.keys}
    if isinstance(idx, (BTree, RB.BTree)):
        return {"keys": idx.keys, "fanout": idx.fanout,
                **{f"level{i}": lv for i, lv in enumerate(idx.levels)}}
    if isinstance(idx, (CHTIndex, RB.CHTIndex)):
        c = idx.cht
        return {"keys": idx.keys, "cells": c.cells, "r": c.r,
                "delta": c.delta, "max_depth": c.max_depth}
    if isinstance(idx, (PGMIndex, RB.PGMIndex)):
        out = {"keys": idx.keys, "eps": idx.eps}
        for i, lv in enumerate(idx.levels):
            out[f"level{i}.keys"] = lv.keys
            out[f"level{i}.positions"] = lv.positions
        return out
    if isinstance(idx, (RadixSpline, RB.RadixSpline)):
        t = idx.table
        return {"keys": idx.keys, "eps": idx.eps,
                "spline.keys": idx.spline.keys,
                "spline.positions": idx.spline.positions,
                "table": t.table, "r": t.r, "shift": t.shift,
                "min_key": t.min_key}
    assert isinstance(idx, (RMI, RB.RMI))
    return {"keys": idx.keys, "min_key": idx.min_key, "scale": idx.scale,
            "slopes": idx.slopes, "intercepts": idx.intercepts,
            "first_keys": idx.first_keys, "err_lo": idx.err_lo,
            "err_hi": idx.err_hi}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dataset", DATASETS)
def test_baseline_parity_with_reference(dataset, name):
    """Same built arrays (dtype and bits), same ``size_bytes`` and ``name``,
    same ranks wherever the reference answers the lower bound; the port
    answers it everywhere."""
    _, build, r_build = _builder(name)
    keys = _unique_if_needed(name, generate(dataset, 50_000))
    idx, ref = build(keys.copy()), r_build(keys.copy())
    got_arrays, want_arrays = _built_arrays(idx), _built_arrays(ref)
    assert got_arrays.keys() == want_arrays.keys()
    for k, want in want_arrays.items():
        got, want = np.atleast_1d(got_arrays[k]), np.atleast_1d(want)
        assert got.dtype == want.dtype, k
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), k
    assert idx.size_bytes == ref.size_bytes and idx.name == ref.name
    present, other = _queries(keys, np.random.default_rng(1))
    q = np.concatenate([present, other])
    got, want = idx.lookup(q), _ref_lookup(ref, q)
    exact = np.searchsorted(keys, q, side="left")
    assert np.array_equal(got, exact)
    right = want == exact
    assert right[:present.size].all()       # the reference on present keys
    assert np.array_equal(got[right], want[right])


@pytest.mark.parametrize("dataset", DATASETS)
def test_predictions_bit_identical_below_2_53(dataset):
    """Below 2^53 the exact 64-bit difference and the reference's absolute
    float64 conversion give the same prediction, bit for bit."""
    # every dataset shifted below 2^53 (sorted order and duplicates kept)
    keys = generate(dataset, 50_000) >> np.uint64(11)
    rng = np.random.default_rng(2)
    q = np.concatenate([keys[rng.integers(0, keys.size, 5000)],
                        rng.integers(keys[0], keys[-1], 5000,
                                     dtype=np.uint64)])
    rs, r_rs_ = build_radixspline(keys, eps=16), r_rs(keys, eps=16)
    assert np.array_equal(rs.predict(q).view(np.uint64),
                          r_rs_.predict(q).view(np.uint64))
    rmi, r_rmi_ = build_rmi(keys, n_models=2048), r_rmi(keys, n_models=2048)
    for got, want in zip(rmi.predict(q), r_rmi_.predict(q)):
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    for lv, rlv in zip(build_pgm(keys, 16).levels, r_pgm(keys, 16).levels):
        assert np.array_equal(lv.predict(q).view(np.uint64),
                              rlv.predict(q).view(np.uint64))


def _dense_keys_near_2_62():
    rng = np.random.default_rng(0)
    return np.sort((1 << 62) + rng.integers(0, 5_000, 20_000,
                                            dtype=np.uint64))


@pytest.mark.parametrize("name", NAMES)
def test_searchsorted_on_dense_keys_near_2_62(name):
    """R1 and R8: 20,000 keys over a 5,000-wide span above 2^62, where
    neighbouring keys share one float64. Every port baseline answers the
    lower bound of its present keys."""
    _, build, _ = _builder(name)
    keys = _unique_if_needed(name, _dense_keys_near_2_62())
    idx = build(keys)
    assert np.array_equal(idx.lookup(keys),
                          np.searchsorted(keys, keys, side="left"))


def test_rmi_exact_difference_above_2_53():
    """R8: the reference's RMI converts absolute keys to float64 before it
    takes the leaf model's input, so on dense keys above 2^62 most
    predictions leave the recorded error window. The port takes the exact
    64-bit difference, as the build fits it."""
    keys = _dense_keys_near_2_62()
    want = np.searchsorted(keys, keys, side="left")
    idx, ref = build_rmi(keys, n_models=2048), r_rmi(keys, n_models=2048)
    assert np.array_equal(idx.slopes, ref.slopes)
    assert np.array_equal(idx.err_hi, ref.err_hi)
    assert np.array_equal(idx.lookup(keys), want)
    # the reference's fault (R8); if this starts to pass, R8 was fixed
    assert np.count_nonzero(ref.lookup(keys) != want) == 10481


@pytest.mark.parametrize("dataset", DATASETS)
def test_absent_keys_outside_the_window(dataset):
    """R9: an RMI leaf's error bounds cover its own keys only, and a spline
    window ends inside a run of duplicates, so an absent key's window can
    miss its lower bound and the reference answers a wrong one. The port
    answers every window that is not conclusive by a full binary search."""
    keys = generate(dataset, 50_000)
    q = _queries(keys, np.random.default_rng(1))[1][:-6]
    want = np.searchsorted(keys, q, side="left")
    wrong = {}
    for name in ("RadixSpline", "PGM", "RMI"):
        _, build, r_build = _builder(name)
        assert np.array_equal(build(keys).lookup(q), want), name
        wrong[name] = int(np.count_nonzero(r_build(keys).lookup(q) != want))
    # the reference's faults (R9): the RMI's on every dataset, the
    # splines' past wiki's duplicate runs
    assert wrong["RMI"] > 0
    assert (wrong["RadixSpline"] > 0) == (dataset == "wiki")


def test_pgm_levels_stop_when_a_level_keeps_every_key():
    """R10: above 2^53 the spline build's float64 repair pass can keep every
    point of a level, and the reference's PGM then builds that level again
    forever. The port stops at the first level that does not shrink; where
    every level shrinks (the reference's loop ends) both build the same
    levels."""
    keys = _dense_keys_near_2_62()
    pgm = build_pgm(keys, 1)
    top = pgm.levels[-1]
    assert top.keys.size > 64
    # the reference's loop would rebuild this level unchanged
    again = r_build_spline(top.keys, 1)
    assert again.keys.size == top.keys.size
    assert np.array_equal(again.keys, top.keys)
    assert np.array_equal(pgm.lookup(keys),
                          np.searchsorted(keys, keys, side="left"))
