"""The port's per-index lookup path against the reference, exactly.

``LearnedIndex`` / ``DevicePlex`` of ``repro_torch`` on ``device="cpu"`` (the
plain versions of K2/K3 and K4) are held against the reference's
``DevicePlex.lookup`` (its Pallas kernels in interpret mode) and
``JnpPlex.lookup`` on the four datasets and on duplicate-heavy keys; the host
lookup (``backend="numpy"``) against the reference's ``PLEX.lookup`` below
2^53 and against ``np.searchsorted`` where the reference's is wrong (ROADMAP
queue 3, R1 and R2); ``plex_from_arrays`` against the reference's planes;
and the guards. ``gpu`` tests count the launches of one lookup on a card.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.core as R
from repro.data import generate
from repro.kernels import planes as RP
from repro.kernels.jnp_lookup import JnpPlex
from repro.kernels.ops import DevicePlex as RDevicePlex
from repro.kernels.pairs import join_u64
from repro_torch.convert import plex_from_arrays
from repro_torch.core import BACKENDS, LearnedIndex, build_plex
from repro_torch.kernels import bounded_search as BS
from repro_torch.kernels import planes as TP
from repro_torch.kernels import segment_lookup as SEG
from repro_torch.kernels.keys import to_biased
from repro_torch.kernels.ops import DevicePlex

from conftest import sorted_u64
from test_torch_segment_lookup import _forced, _reference_bases

U64_MAX = (1 << 64) - 1


def _queries(keys, rng, n=2048):
    """Present keys, absent ones inside the key range, and 0."""
    return np.concatenate([
        np.asarray([0, keys[0], keys[-1]], np.uint64),
        keys[rng.integers(0, keys.size, n - 259)],
        rng.integers(keys[0], keys[-1], 256, dtype=np.uint64)])


def _arrays(px):
    """A reference PLEX as the plain arrays ``plex_from_arrays`` takes."""
    lay = px.layer
    layer = (dict(kind="radix", table=lay.table, shift=lay.shift, r=lay.r,
                  min_key=lay.min_key)
             if isinstance(lay, R.RadixTable)
             else dict(kind="cht", cells=lay.cells, r=lay.r,
                       delta=lay.delta, max_depth=lay.max_depth))
    return dict(keys=px.keys, spline_keys=px.spline.keys,
                spline_positions=px.spline.positions, layer=layer,
                tuning=dataclasses.asdict(px.tuning), eps=px.eps)


def _keyset(name):
    if name == "dups":
        # duplicate-heavy: 40k keys over 3k distinct values
        rng = np.random.default_rng(9)
        return np.sort(rng.integers(0, 3_000, 40_000, dtype=np.uint64)
                       * np.uint64(1 << 40))
    return generate(name, 40_000, 3)


@pytest.mark.parametrize("name", ["amzn", "face", "osm", "wiki", "dups"])
def test_lookup_path_matches_reference(name):
    keys = _keyset(name)
    rng = np.random.default_rng(1)
    q = _queries(keys, rng)
    rpx = R.build_plex(keys, 32)
    ref = RDevicePlex.from_plex(rpx, block=512).lookup(q)
    assert np.array_equal(JnpPlex.from_plex(rpx, block=512).lookup(q), ref)
    idx = LearnedIndex.build(keys.copy(), 32, device="cpu")
    assert idx.plex.tuning.kind == rpx.tuning.kind
    got = idx.lookup(q)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.searchsorted(keys, q, "left"))
    # a batch that is not a block multiple
    dp = DevicePlex.from_plex(idx.plex, block=128, device="cpu")
    assert np.array_equal(dp.lookup(q[:1000]), ref[:1000])
    # far past the end: searchsorted (the reference's radix prefix wraps
    # there, ROADMAP queue 3, R5)
    far = np.asarray([U64_MAX, int(keys[-1]) + 1], np.uint64)
    assert np.array_equal(idx.lookup(far), [keys.size, keys.size])


def test_window_bases_of_tuned_index_match_pallas_kernel():
    """The bases ``DevicePlex`` probes from, with the tuner's own layers,
    equal the reference's Pallas kernel's."""
    for name in ("face", "osm"):
        keys = generate(name, 30_000, 1)
        rpx = R.build_plex(keys, 16)
        q = _queries(keys, np.random.default_rng(2), 1024)
        dp = DevicePlex.from_plex(build_plex(keys.copy(), 16), device="cpu")
        got = SEG.window_base(dp.planes, torch.from_numpy(to_biased(q)))
        want = _reference_bases(rpx, q,
                                RP._host_statics(rpx).static["mode"])
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["wiki", "below53"])
def test_host_lookup_matches_reference_below_2_53(name):
    """Keys below 2^53: the port's host prediction and lookup equal the
    reference's bit for bit, absent keys included."""
    if name == "wiki":
        keys = generate("wiki", 40_000, 5)
    else:
        keys = sorted_u64(np.random.default_rng(3), 40_000, dups=True,
                          spread=52)
    rng = np.random.default_rng(4)
    q = _queries(keys, rng)
    rpx = R.build_plex(keys, 16)
    idx = LearnedIndex.build(keys.copy(), 16, device="cpu")
    assert np.array_equal(idx.plex.predict(q), rpx.predict(q))
    assert np.array_equal(idx.plex.spline.predict(q), rpx.spline.predict(q))
    got = idx.lookup(q, backend="numpy")
    assert np.array_equal(got, rpx.lookup(q))
    assert np.array_equal(got, np.searchsorted(keys, q, "left"))


def test_host_lookup_exact_on_dense_keys_near_2_62():
    """R1: 20,000 keys over a 5,000-wide span above 2^62 at eps 1. The
    reference's host lookup converts absolute keys to float64 (1024 apart
    there) and answers 6 ranks wrong; the port takes the exact difference
    first and answers searchsorted."""
    rng = np.random.default_rng(0)
    keys = np.sort((1 << 62) + rng.integers(0, 5_000, 20_000,
                                            dtype=np.uint64))
    want = np.searchsorted(keys, keys, "left")
    rpx = R.build_plex(keys, 1)
    px = plex_from_arrays(**_arrays(rpx))
    assert np.array_equal(px.lookup(keys), want)
    idx = LearnedIndex(plex=px, device="cpu")
    assert np.array_equal(idx.lookup(keys, backend="numpy"), want)
    assert np.array_equal(idx.lookup(keys), want)
    # the reference's fault (R1); if this starts to pass, R1 was fixed
    assert np.count_nonzero(rpx.lookup(keys) != want) == 6


def test_host_lookup_past_the_end_clips_the_prediction():
    """R2: on wiki keys (a sparse spline over a narrow span) the reference's
    host prediction for 2^64 - 1 overflows its int64 cast and the lookup
    answers a rank inside the array. The port clips the prediction to the
    key range first and answers n."""
    keys = generate("wiki", 40_000, 0)
    q = np.asarray([keys[5], U64_MAX, int(keys[-1]) + 7], np.uint64)
    want = np.searchsorted(keys, q, "left")
    idx = LearnedIndex.build(keys.copy(), 64, device="cpu")
    assert np.array_equal(idx.lookup(q, backend="numpy"), want)
    # the reference's fault (R2); if this starts to pass, R2 was fixed
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = R.build_plex(keys, 64).lookup(q)
    assert ref[1] != want[1] == keys.size


@pytest.mark.parametrize("kind", ["tuned", "radix", "cht"])
def test_plex_from_arrays_carries_reference_index(kind):
    """A reference-built PLEX, handed over as arrays, gives the port the
    reference's planes and ranks with no rebuild."""
    keys = generate("amzn", 30_000, 2)
    rpx = (R.build_plex(keys, 16) if kind == "tuned"
           else _forced(keys, 16, kind))
    px = plex_from_arrays(**_arrays(rpx))
    want = RP.build_planes(rpx)
    got = TP.build_planes(px, "cpu")

    def biased(hi, lo):
        return to_biased(join_u64(np.asarray(hi), np.asarray(lo)))
    assert np.array_equal(got.sk.numpy(), biased(want.skhi, want.sklo))
    assert np.array_equal(got.spos.numpy(), np.asarray(want.spos))
    assert np.array_equal(got.dk.numpy(), biased(want.dhi, want.dlo))
    lname = "table" if want.kind == "radix" else "cells"
    assert np.array_equal(
        got.layer_arrays[lname].numpy().view(np.uint32),
        np.asarray(want.layer_arrays[lname]).astype(np.uint32))
    assert (got.kind, got.n_data, got.n_real, got.eps_eff, got.window) == \
        (want.kind, want.n_data, want.n_real, want.eps_eff, want.window)
    q = _queries(keys, np.random.default_rng(6), 1024)
    ref = RDevicePlex.from_plex(rpx).lookup(q)
    assert np.array_equal(LearnedIndex(plex=px, device="cpu").lookup(q), ref)


def test_learned_index_surfaces():
    keys = generate("osm", 20_000, 0)
    idx = LearnedIndex.build(keys.copy(), 32, block=256, device="cpu")
    assert set(BACKENDS) == {"cuda", "torch", "numpy"}
    assert idx.device == torch.device("cpu")
    assert idx.backend_impl("numpy") is idx.plex
    assert idx.backend_impl() is idx.backend_impl("cuda")
    assert isinstance(idx.backend_impl(), DevicePlex)
    assert idx.eps == 32 and idx.keys is idx.plex.keys
    assert idx.size_bytes == idx.plex.size_bytes
    idx.warmup()
    q = keys[::37]
    want = np.searchsorted(keys, q, "left")
    st = idx.stacked_impl(probe="count")
    assert st is idx.stacked_impl(probe="count")
    assert np.array_equal(st.lookup(q), want)
    assert idx.lookup(np.zeros(0, np.uint64)).size == 0


def test_guards():
    keys = generate("amzn", 5_000, 0)
    px = build_plex(keys, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        LearnedIndex(plex=px, block=100, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        DevicePlex.from_plex(px, block=100, device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        LearnedIndex(plex=px, device="cpu").lookup(keys, backend="pallas")
    # the float32 rank plane holds < 2^24 positions
    big = dataclasses.replace(px, spline=dataclasses.replace(
        px.spline, positions=px.spline.positions.copy()))
    big.spline.positions[-1] = 1 << 24
    with pytest.raises(ValueError, match="2\\^24"):
        TP.build_planes(big, "cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        LearnedIndex(plex=big, device="cpu").lookup(keys[:4])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    keys = generate("amzn", 2_000, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LearnedIndex.build(keys, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        LearnedIndex.build(keys, 8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePlex.from_plex(build_plex(keys, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["face", "osm"])
def test_one_launch_of_each_kernel_per_lookup_on_card(name):
    """On a CUDA card: one launch of K2-or-K3 fused with K4 per lookup,
    whatever the batch (and no launch of either alone), and the ranks of
    the plain pipeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys = generate(name, 40_000, 0)
    idx = LearnedIndex.build(keys.copy(), 32, device="cuda")
    idx.warmup()
    q = _queries(keys, np.random.default_rng(1))
    seg0, bs0, fused0 = SEG.launches, BS.launches, SEG.fused_launches
    got = idx.lookup(q)
    assert (SEG.launches - seg0, BS.launches - bs0,
            SEG.fused_launches - fused0) == (0, 0, 1)
    cpu = LearnedIndex(plex=idx.plex, device="cpu")
    assert np.array_equal(got, cpu.lookup(q))
    assert np.array_equal(got, np.searchsorted(keys, q, "left"))
