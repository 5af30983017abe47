"""Port key representation (biased int64) against the reference's u32 pairs.

Every op of ``repro_torch.kernels.keys`` is held against its counterpart in
``repro.kernels.pairs`` on edge keys and random keys; all comparisons are
exact (integers, and float32 bit patterns for ``diff_to_f32``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pairs
from repro_torch.kernels import keys as K

EDGE = np.asarray([0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
                   (1 << 32) + 1, (1 << 53) + 1, (1 << 62) + 9985,
                   (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 2,
                   (1 << 64) - 1], dtype=np.uint64)


@pytest.fixture
def u64(rng):
    rand = rng.integers(0, np.iinfo(np.uint64).max, 200, dtype=np.uint64,
                        endpoint=True)
    return np.concatenate([EDGE, rand])


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(K.to_biased(x))


def _pair(x: np.ndarray):
    hi, lo = pairs.split_u64(x)
    return jnp.asarray(hi), jnp.asarray(lo)


def test_bias_roundtrip_and_order(u64):
    b = K.to_biased(u64)
    assert b.dtype == np.int64
    assert np.array_equal(K.from_biased(b), u64)
    order = np.argsort(u64, kind="stable")
    assert np.array_equal(np.argsort(b, kind="stable"), order)
    assert K.to_biased(np.asarray([(1 << 64) - 1], np.uint64))[0] \
        == K.MAX_BIASED


@pytest.mark.parametrize("op", ["lt", "le"])
def test_compare_matches_pairs(u64, op):
    a = np.repeat(u64, u64.size)
    b = np.tile(u64, u64.size)
    ah, al = _pair(a)
    bh, bl = _pair(b)
    want = np.asarray(getattr(pairs, f"pair_{op}")(ah, al, bh, bl))
    got = getattr(K, op)(_t(a), _t(b)).numpy()
    assert np.array_equal(got, want)


def test_diff_words_and_f32_match_pairs(u64):
    a = np.repeat(u64, u64.size)
    b = np.tile(u64, u64.size)
    keep = a >= b                       # pair_sub's contract: a >= b
    a, b = a[keep], b[keep]
    ah, al = _pair(a)
    bh, bl = _pair(b)
    wh, wl = pairs.pair_sub(ah, al, bh, bl)
    d = K.diff(_t(a), _t(b))
    gh, gl = K.split_words(d)
    assert np.array_equal(gh.numpy(), np.asarray(wh).astype(np.int64))
    assert np.array_equal(gl.numpy(), np.asarray(wl).astype(np.int64))
    assert np.array_equal(d.numpy().view(np.uint64), a - b)
    want = np.asarray(pairs.pair_to_f32(wh, wl))
    got = K.diff_to_f32(d).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_diff_to_f32_rounds_twice_not_once():
    # f32(hi)*2^32 + f32(lo) is not (float)u64: this value rounds apart
    x = np.asarray([(1 << 56) + (1 << 32) + 0x80000001], np.uint64)
    d = torch.from_numpy(x.view(np.int64))
    got = K.diff_to_f32(d).numpy()
    want = np.asarray(pairs.pair_to_f32(*_pair(x)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] != x.astype(np.float32)[0]


@pytest.mark.parametrize("cap", [0, 255, (1 << 20) - 1, (1 << 31) - 1])
def test_shr_sat_saturates_the_whole_shift(u64, cap):
    """The radix prefix of both plain pipelines: ``min(d >> s, cap)`` over
    the whole u64 (R5). Wherever ``d >> s < 2^31`` it is the reference's
    low-32-bit shift (``pair_shr_dyn``), cast to int32 and clipped."""
    d = np.repeat(u64, 64)
    s = np.tile(np.arange(64, dtype=np.int64), u64.size)
    got = K.shr_sat(torch.from_numpy(d.view(np.int64)), torch.from_numpy(s),
                    cap).numpy()
    full = [int(x) >> int(k) for x, k in zip(d, s)]
    assert got.tolist() == [min(v, cap) for v in full]
    dh, dl = _pair(d)
    ref = np.asarray(pairs.pair_shr_dyn(dh, dl, jnp.asarray(s, jnp.int32)))
    ref = np.clip(ref.astype(np.int32).astype(np.int64), 0, cap)
    narrow = np.asarray(full, dtype=object) < (1 << 31)
    assert narrow.any() and not narrow.all()
    assert np.array_equal(got[narrow], ref[narrow])
    # a scalar shift gives the same as one per element
    assert np.array_equal(
        K.shr_sat(torch.from_numpy(u64.view(np.int64)), 0, cap).numpy(),
        got[::64])


@pytest.mark.parametrize("r", [1, 3, 6, 8, 16, 30])
def test_extract_bits_matches_pairs(u64, r):
    qh, ql = _pair(u64)
    for offset in range(0, 64, r):
        want = np.asarray(pairs.extract_bits(qh, ql, offset, r))
        got = K.extract_bits(_t(u64), offset, r).numpy()
        assert np.array_equal(got, want.astype(np.int64)), (offset, r)
