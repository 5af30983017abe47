"""The summary probe (K1's and K4's bisect form) against the reference.

``bounded_search.summary_lower_bound`` bisects the samples of a data plane's
``KeySummary`` (every 8th key; every 64th first with two levels) and counts
in one 8-key segment. Here its plain version, with one level and with two,
is held to the reference's probe in both of its forms
(``probe_lower_bound``) and to the reference's Pallas ``bounded_search`` on
windows gathered from the same plane (interpret mode, as
``test_torch_segment_lookup.py`` runs it): duplicate runs that cross sample
boundaries, windows of 128, 256 and 384 keys, bases at both ends of the
plane, windows that miss the lower bound on either side, the extreme
queries and the max-key padding. The summary's rows are checked after
``build_stacked_planes`` and after a service merge, and the serving path's
launches are checked to ask for overlap on every launch but a dispatch's
first. ``gpu`` tests hold the kernels to the plain versions on a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bounded_search import bounded_search as r_bounded_search
from repro.kernels.pairs import split_u64
from repro_torch.core import build_plex, shard_offsets
from repro_torch.data import generate
from repro_torch.kernels import bounded_search as BS
from repro_torch.kernels import planes as TP
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.keys import MAX_BIASED, from_biased, to_biased
from repro_torch.serving import PlexService

U64_MAX = (1 << 64) - 1
N_REAL = 5_000


def _plane(dup: int, rng, n_real: int = N_REAL, pad: bool = True):
    """Sorted keys in runs of ``dup`` copies, the first run cut short so
    runs cross sample boundaries, then the max-key padding (to a multiple
    of 128, as the planes pad) unless ``pad`` is off."""
    start = int(rng.integers(1, dup + 1)) if dup > 1 else 0
    vals = np.sort(rng.choice(1 << 40, n_real // dup + 2, replace=False)
                   .astype(np.uint64) + 1)
    keys = np.repeat(vals, dup)[start:start + n_real]
    n = TP.round_up(n_real, 128) if pad else n_real
    dk = np.full(n, MAX_BIASED, np.int64)
    dk[:n_real] = to_biased(keys)
    return dk


def _cases(dk: np.ndarray, window: int, rng, b: int = 1024):
    """Queries and bases: present keys (first occurrences of duplicate
    runs among them), absent keys, 0 and 2^64 - 1; bases at 0 and at
    n - window, around the lower bound, and windows wholly below or above
    it."""
    keys = from_biased(dk)
    n = dk.size
    q = np.concatenate([keys[rng.integers(0, n, b // 2)],
                        rng.integers(0, 1 << 41, b // 2 - 4, dtype=np.uint64),
                        np.asarray([0, U64_MAX, 0, U64_MAX], np.uint64)])
    lb = np.searchsorted(keys, q, "left")
    base = lb - rng.integers(0, window + 1, b)
    k = b // 8
    base[:k] = 0
    base[k:2 * k] = n - window
    base[2 * k:3 * k] = lb[2 * k:3 * k] + rng.integers(1, 40, k)
    base[3 * k:4 * k] = lb[3 * k:4 * k] - window - rng.integers(1, 40, k)
    return q, np.clip(base, 0, n - window).astype(np.int32)


def _reference(dk: np.ndarray, q: np.ndarray, base: np.ndarray,
               window: int) -> np.ndarray:
    """The reference's ``bounded_search`` on windows gathered ahead."""
    kh, kl = split_u64(from_biased(dk))
    idx = base[:, None].astype(np.int64) + np.arange(window)
    qh, ql = map(jnp.asarray, split_u64(q))
    return np.asarray(r_bounded_search(qh, ql, jnp.asarray(kh[idx]),
                                       jnp.asarray(kl[idx]),
                                       jnp.asarray(base)))


@pytest.mark.parametrize("window", [128, 256, 384])
@pytest.mark.parametrize("dup", [1, 7, 8, 9, 64])
def test_summary_probe_matches_reference(dup, window):
    """One level and two against both of the reference's forms and its
    kernel, on every kind of case at once."""
    rng = np.random.default_rng(dup * 1000 + window)
    dk = _plane(dup, rng)
    q, base = _cases(dk, window, rng)
    dkt, qt, bt = (torch.from_numpy(a) for a in (dk, to_biased(q), base))
    want = _reference(dk, q, base, window)
    for mode in BS.PROBE_MODES:
        got = BS.probe_lower_bound(dkt, qt, bt.long(), window=window,
                                   mode=mode)
        assert np.array_equal(got.numpy(), want), mode
    for levels in (1, 2):
        sm = TP.build_summary(dkt, dk.size, levels)
        got = BS.summary_lower_bound(dkt, sm, qt, bt.long(), window=window)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), levels


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("n_real", [1_000, 8_191, 8_200])
def test_summary_probe_on_unpadded_planes(n_real, levels):
    """A plane whose length is not a multiple of 8 or 64 (K4 takes any
    ``dk``): the last segment of each level is partial."""
    rng = np.random.default_rng(n_real + levels)
    dk = _plane(9, rng, n_real=n_real, pad=False)
    window = 256
    q, base = _cases(dk, window, rng, b=512)
    dkt, qt, bt = (torch.from_numpy(a) for a in (dk, to_biased(q), base))
    sm = TP.build_summary(dkt, dk.size, levels)
    assert sm.l1.numel() == -(-n_real // 8)
    assert sm.l2.numel() == -(-n_real // 64)
    got = BS.summary_lower_bound(dkt, sm, qt, bt.long(), window=window)
    assert np.array_equal(got.numpy(), _reference(dk, q, base, window))


@pytest.mark.parametrize("mode", ["count", "bisect"])
def test_bounded_search_makes_a_summary_when_given_none(mode):
    rng = np.random.default_rng(11)
    dk = _plane(8, rng)
    q, base = _cases(dk, 256, rng, b=512)
    dkt, qt, bt = (torch.from_numpy(a) for a in (dk, to_biased(q), base))
    want = _reference(dk, q, base, 256)
    before = BS.launches
    for sm in (None, TP.build_summary(dkt, dk.size, 2)):
        got = BS.bounded_search(dkt, qt, bt, window=256, mode=mode,
                                summary=sm)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert BS.launches == before
    with pytest.raises(ValueError, match="summary of"):
        BS.bounded_search(dkt, qt, bt, window=256, mode=mode,
                          summary=TP.build_summary(dkt[:1024], 1024, 1))


def test_summary_levels_rule():
    """One level while the 8th-key summary (1 B a key) fits in half of the
    50 MB L2: 2^24 keys and the 16M-key kernel phase take one, the
    service's 200M keys two."""
    assert TP.summary_levels(1 << 24) == TP.summary_levels(16_000_000) == 1
    assert TP.summary_levels(TP.L2_BYTES // 2) == 1
    assert TP.summary_levels(TP.L2_BYTES // 2 + 1) == 2
    assert TP.summary_levels(200_000_000) == 2
    with pytest.raises(ValueError, match="1 or 2"):
        TP.build_summary(torch.zeros(64, dtype=torch.int64), 64, 3)


def _assert_summary_of(planes, row: int):
    dk = planes.dk.view(-1, row)
    sm = planes.summary
    assert sm.row == row
    assert torch.equal(sm.l1, dk[:, ::8].reshape(-1))
    assert torch.equal(sm.l2, dk[:, ::64].reshape(-1))
    assert sm.nbytes == (sm.l1.numel() + sm.l2.numel()) * 8


def test_stacked_summary_rows():
    """Each shard's row of the stacked data plane is sampled from its own
    start; the levels follow the keys the planes share the card with."""
    keys = generate("amzn", 40_000, 0)
    offs = np.searchsorted(keys, keys[[0, 7_000, 23_000]], "left")
    plexes = [build_plex(keys[lo:hi], 32)
              for lo, hi in zip(offs, np.append(offs[1:], keys.size))]
    sp = TP.build_stacked_planes(plexes, offs, "cpu")
    _assert_summary_of(sp, sp.n_data_max)
    assert sp.summary.l1.numel() == sp.n_shards * sp.summary.n1
    assert sp.summary.levels == 1
    big = TP.build_stacked_planes(plexes, offs, "cpu",
                                  summary_keys=200_000_000)
    assert big.summary.levels == 2
    assert torch.equal(big.summary.l1, sp.summary.l1)
    pp = TP.build_planes(plexes[1], "cpu")
    _assert_summary_of(pp, pp.n_data)


def test_stacked_plain_probe_forms_agree():
    """The stacked pipeline's summary probe, one level and two, answers as
    its count form and as searchsorted (shard ids and bases included)."""
    keys = generate("face", 60_000, 0)
    offs = shard_offsets(keys, 3)
    plexes = [build_plex(keys[lo:hi], 32)
              for lo, hi in zip(offs, np.append(offs[1:], keys.size))]
    sp = TP.build_stacked_planes(plexes, offs, "cpu")
    rng = np.random.default_rng(12)
    q = np.concatenate([keys[rng.integers(0, keys.size, 3_000)],
                        rng.integers(keys[0], keys[-1], 500, dtype=np.uint64),
                        np.asarray([0, U64_MAX], np.uint64)])
    qt = torch.from_numpy(to_biased(q))
    want = SL.stacked_lookup_plain(sp, "count", qt)
    for levels in (1, 2):
        sp.summary = dataclasses.replace(sp.summary, levels=levels)
        got = SL.stacked_lookup_plain(sp, "bisect", qt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert np.array_equal(np.minimum(want[0].numpy(), keys.size),
                          np.searchsorted(keys, q, "left"))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_merge_rebuilds_the_summary(n_shards):
    """A merge builds new planes, and with them a new summary of the merged
    data plane; lookups through it equal searchsorted."""
    rng = np.random.default_rng(13)
    keys = generate("amzn", 30_000, 0)
    svc = PlexService(keys, eps=32, n_shards=n_shards, block=512,
                      device="cpu", merge_threshold=0)
    old = svc._state.stacked
    svc.insert(rng.integers(keys[0], keys[-1], 700, dtype=np.uint64))
    svc.delete(keys[rng.integers(0, keys.size, 300)])
    assert svc.merge()
    new = svc._state.stacked
    assert new is not old and new.planes.summary is not old.planes.summary
    _assert_summary_of(new.planes, new.planes.n_data_max)
    assert new.planes.summary.levels == TP.summary_levels(svc.snapshot.n_keys)
    logical = svc.logical_keys()
    q = np.concatenate([logical[rng.integers(0, logical.size, 2_000)],
                        np.asarray([0, U64_MAX], np.uint64)])
    assert np.array_equal(svc.lookup(q), np.searchsorted(logical, q, "left"))


class _Recorder:
    """``SL.stacked_lookup`` replaced by a recorder of each launch's
    ``overlap`` request (the plain version still answers)."""

    def __init__(self, monkeypatch):
        self.overlap = []
        orig = SL.stacked_lookup

        def record(sp, probe, q, delta=None, **kw):
            self.overlap.append(kw.get("overlap", False))
            return orig(sp, probe, q, delta, **kw)
        monkeypatch.setattr(SL, "stacked_lookup", record)


def test_dispatch_overlaps_every_launch_but_the_first(monkeypatch):
    keys = generate("amzn", 30_000, 0)
    svc = PlexService(keys, eps=32, n_shards=2, block=512, device="cpu")
    assert svc.fused
    rec = _Recorder(monkeypatch)
    q = keys[np.random.default_rng(14).integers(0, keys.size, 1_700)]
    for _ in range(2):
        b0 = svc.stats.batches
        n0 = len(rec.overlap)
        assert np.array_equal(svc.lookup(q), np.searchsorted(keys, q))
        assert svc.stats.batches - b0 == 4
        assert rec.overlap[n0:] == [False, True, True, True]
    st = svc._state.stacked
    qd = torch.from_numpy(to_biased(q))
    rec.overlap.clear()
    st.dispatch(qd, chained=True)
    assert rec.overlap == [True] * 4


def test_per_shard_path_overlaps_every_launch_but_the_first(monkeypatch):
    keys = generate("face", 100_000, 0)
    svc = PlexService(keys, eps=32, n_shards=2, block=512, device="cpu")
    assert not svc.fused
    rec = _Recorder(monkeypatch)
    rng = np.random.default_rng(15)
    q = keys[rng.integers(0, keys.size, 1_500)]
    b0 = svc.stats.batches
    assert np.array_equal(svc.lookup(q), np.searchsorted(keys, q))
    n = svc.stats.batches - b0
    assert n == len(rec.overlap) >= 4
    assert rec.overlap == [False] + [True] * (n - 1)
    # a request that reaches one shard only: still one first launch
    one = keys[:100]
    rec.overlap.clear()
    svc.lookup(one)
    assert rec.overlap == [False]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [1, 2])
def test_summary_kernels_match_plain_on_card(levels):
    """On a CUDA card: K4 and K1 through the summary probe against their
    plain versions on the same device inputs, exactly (``python3
    chip_smoke.py`` does the same at full size)."""
    dev = _cuda()
    rng = np.random.default_rng(16)
    for dup in (1, 9, 64):
        dk = _plane(dup, rng)
        q, base = _cases(dk, 256, rng)
        dkt, qt, bt = (torch.from_numpy(a).to(dev)
                       for a in (dk, to_biased(q), base))
        sm = TP.build_summary(dkt, dk.size, levels)
        got = BS.bounded_search(dkt, qt, bt, window=256, summary=sm)
        assert torch.equal(got, BS.bounded_search_plain(
            dkt, qt, bt, window=256, mode="bisect", summary=sm))
    keys = generate("amzn", 60_000, 0)
    offs = shard_offsets(keys, 3)
    plexes = [build_plex(keys[lo:hi], 32)
              for lo, hi in zip(offs, np.append(offs[1:], keys.size))]
    sp = TP.build_stacked_planes(plexes, offs, dev)
    sp.summary = dataclasses.replace(sp.summary, levels=levels)
    qt = torch.from_numpy(to_biased(keys[rng.integers(0, keys.size, 4096)]
                                    )).to(dev)
    for overlap in (False, True):
        got = SL.stacked_lookup(sp, "bisect", qt, aux=True, overlap=overlap)
        for g, w in zip(got, SL.stacked_lookup_plain(sp, "bisect", qt)):
            assert torch.equal(g, w)
