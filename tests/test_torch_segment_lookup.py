"""K2, K3 and K4 of the port against the reference, exactly.

Window bases of ``repro_torch.kernels.segment_lookup`` (plain versions,
which run here) are held bit for bit against the reference's Pallas kernels
``radix_segment_lookup`` / ``cht_segment_lookup`` in interpret mode and
against the dense oracle ``ref.window_base_ref``, in every search form
(count, bisect, adaptive) over forced radix and CHT layers whose spline
windows span 1 to 992 points (8 and ``COUNT_MODE_MAX`` points among them),
on unique keys, duplicated keys and the one-point spline of R4; the fused
K2/K3 + K4 form's plain version is K4 on those bases. The K4 probe
``bounded_search`` is held, in both forms, against the reference's
``bounded_search`` on windows gathered from the same plane and against
``lower_bound_ref``. The plain versions refuse out-of-bounds gathers, so
every case also shows that no gather leaves its plane. ``gpu`` tests hold
the kernels against the plain versions on a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import planes as RP
from repro.kernels import ref as RREF
from repro.kernels.bounded_search import bounded_search as r_bounded_search
from repro.kernels.jnp_lookup import JnpPlex
from repro.kernels.ops import DevicePlex as RDevicePlex
from repro.kernels.pairs import extract_bits, split_u64
from repro.kernels.plex_segment_lookup import cht_segment_lookup as r_cht
from repro.kernels.plex_segment_lookup import radix_segment_lookup as r_radix
from repro_torch.kernels import bounded_search as BS
from repro_torch.kernels import planes as TP
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import segment_lookup as SEG
from repro_torch.kernels.keys import to_biased

from test_torch_planes import _port_plex

U64_MAX = (1 << 64) - 1
BLOCK = 512


def _forced(keys, eps, kind, **layer_kw):
    """A reference PLEX with its layer forced to ``kind`` (as
    tests/test_kernels.py forces it)."""
    px = R.build_plex(keys, eps)
    layer = (R.build_radix_table(px.spline.keys, layer_kw.get("r", 8))
             if kind == "radix"
             else R.build_cht(px.spline.keys, layer_kw.get("r", 4),
                              layer_kw.get("delta", 16)))
    return dataclasses.replace(px, layer=layer)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(4)
    return np.unique(rng.integers(0, 1 << 48, 30_000, dtype=np.uint64))


def _key_set(name, keys):
    if name == "unique":
        return keys
    if name == "dups":
        rng = np.random.default_rng(12)
        k = keys.copy()
        k[rng.integers(0, k.size, 6_000)] = k[rng.integers(0, k.size, 6_000)]
        return np.sort(k)
    return np.full(300, 7, np.uint64)          # "one": a one-point spline (R4)


# (id, key set, eps, layer kind, layer parameters); the widest spline window
# (max_win, or delta + 1) in the comment. The first two are the forced
# layers the other tests use.
WINDOW_CASES = [
    ("radix", "unique", 8, "radix", dict(r=8)),        # 5 points
    ("cht", "unique", 8, "cht", dict(r=4, delta=16)),  # 17
    ("radix-2", "unique", 8, "radix", dict(r=12)),     # 2: windows of 1, 2
    ("radix-992", "unique", 1, "radix", dict(r=3)),    # 992
    ("cht-2", "unique", 8, "cht", dict(r=4, delta=1)),
    ("cht-8", "unique", 2, "cht", dict(r=6, delta=7)),
    ("cht-512", "unique", 1, "cht", dict(r=4, delta=511)),
    ("cht-701", "unique", 1, "cht", dict(r=4, delta=700)),
    ("radix-dups", "dups", 4, "radix", dict(r=6)),
    ("cht-dups", "dups", 4, "cht", dict(r=4, delta=32)),
    ("radix-one", "one", 8, "radix", dict(r=1)),
    ("cht-one", "one", 8, "cht", dict(r=2, delta=1)),
]


def _queries(keys, rng, n=2048):
    """Present keys, absent ones in and beyond the key range, and edges."""
    edges = np.asarray([0, 1, int(keys[0]) - 1, int(keys[0]),
                        int(keys[-1]), int(keys[-1]) + 1, U64_MAX,
                        1 << 63], dtype=np.uint64)
    body = np.concatenate([
        keys[rng.integers(0, keys.size, n - 400 - edges.size)],
        rng.integers(keys[0], max(keys[-1], keys[0] + 1), 300,
                     dtype=np.uint64),
        rng.integers(0, U64_MAX, 100, dtype=np.uint64, endpoint=True)])
    return np.concatenate([edges, body])


def _reference_bases(px, q, mode):
    """Window bases of the reference's Pallas kernel (interpret mode)."""
    pp = RP.build_planes(px)
    s = pp.static
    qp, _ = RP.pad_queries(q, BLOCK)
    qh, ql = map(jnp.asarray, split_u64(qp))
    common = dict(eps_eff=pp.eps_eff, n_data=pp.n_data, window=pp.window,
                  mode=mode, block=BLOCK, interpret=True)
    if pp.kind == "radix":
        out = r_radix(qh, ql, pp.layer_arrays["table"], pp.skhi, pp.sklo,
                      pp.spos, shift=s["shift"], r=s["r"],
                      min_hi=s["min_hi"], min_lo=s["min_lo"],
                      max_win=s["max_win"], **common)
    else:
        bins = jnp.stack([extract_bits(qh, ql, lvl * s["r"], s["r"])
                          for lvl in range(s["levels"])])
        out = r_cht(qh, ql, bins, pp.layer_arrays["cells"], pp.skhi,
                    pp.sklo, pp.spos, r=s["r"], levels=s["levels"],
                    delta=s["delta"], **common)
    return np.asarray(out)[:q.size].astype(np.int64)


def _port_planes(px, mode):
    pp = TP.build_planes(_port_plex(px), "cpu")
    pp.static["mode"] = mode
    return pp


@pytest.mark.parametrize("mode", SEG.SEARCH_FORMS)
@pytest.mark.parametrize("case", WINDOW_CASES, ids=[c[0] for c in WINDOW_CASES])
def test_window_bases_match_pallas_kernel(case, mode, keys):
    """Each search form's plain version against the reference's Pallas
    kernel (the adaptive form against its bisect, which equals its count),
    on present keys, absent ones, keys below the minimum and past the end,
    and every spline point."""
    _, key_set, eps, kind, layer_kw = case
    k = _key_set(key_set, keys)
    rng = np.random.default_rng(1)
    px = _forced(k, eps, kind, **layer_kw)
    q = np.concatenate([_queries(np.unique(k), rng), px.spline.keys])
    pp = _port_planes(px, mode)
    assert pp.kind == kind
    qt = torch.from_numpy(to_biased(q))
    before = SEG.launches
    got = SEG.window_base(pp, qt)
    assert SEG.launches == before and got.dtype == torch.int32
    want = _reference_bases(px, q, "bisect" if mode == "adaptive" else mode)
    assert np.array_equal(got.numpy().astype(np.int64), want), \
        np.flatnonzero(got.numpy() != want)[:5]
    for form in SEG.SEARCH_FORMS:
        assert torch.equal(got, SEG.window_base_plain(pp, qt, form))
    # the dense oracle agrees wherever it is defined (q >= the first key)
    inside = q >= k[0]
    oracle = TREF.window_base_ref(qt[inside], pp.sk, pp.spos,
                                  eps_eff=pp.eps_eff, n_data=pp.n_data,
                                  window=pp.window)
    assert torch.equal(got[inside], oracle)
    # the fused form's plain version is K4's summary probe on these bases
    assert torch.equal(SEG.window_probe_plain(pp, qt, mode),
                       BS.bounded_search(pp.dk, qt, got, window=pp.window,
                                         summary=pp.summary))


@pytest.mark.parametrize("kind", ["radix", "cht"])
def test_wrappers_take_reference_signatures(kind, keys):
    """``radix_segment_lookup`` / ``cht_segment_lookup`` called with the
    reference's statics (biased min key) give the planes-level result."""
    rng = np.random.default_rng(2)
    px = _forced(keys, 16, kind)
    pp = _port_planes(px, "bisect")
    s = pp.static
    qt = torch.from_numpy(to_biased(_queries(keys, rng, 1024)))
    common = dict(eps_eff=pp.eps_eff, n_data=pp.n_data, window=pp.window,
                  mode="bisect")
    if kind == "radix":
        got = SEG.radix_segment_lookup(
            qt, pp.layer_arrays["table"], pp.sk, pp.spos, shift=s["shift"],
            r=s["r"], min_key=s["min_key"], max_win=s["max_win"], **common)
    else:
        got = SEG.cht_segment_lookup(
            qt, pp.layer_arrays["cells"], pp.sk, pp.spos, r=s["r"],
            levels=s["levels"], delta=s["delta"], **common)
    assert torch.equal(got, SEG.window_base(pp, qt))


def test_oracles_match_reference_oracles(keys):
    """The port's dense oracles equal the reference's on the same planes."""
    rng = np.random.default_rng(3)
    px = _forced(keys, 8, "radix")
    rp = RP.build_planes(px)
    pp = TP.build_planes(_port_plex(px), "cpu")
    q = keys[rng.integers(0, keys.size, 512)]
    qh, ql = map(jnp.asarray, split_u64(q))
    qt = torch.from_numpy(to_biased(q))
    assert np.array_equal(
        TREF.segment_ref(qt, pp.sk).numpy(),
        np.asarray(RREF.segment_ref(qh, ql, rp.skhi, rp.sklo)))
    assert np.array_equal(
        TREF.window_base_ref(qt, pp.sk, pp.spos, eps_eff=pp.eps_eff,
                             n_data=pp.n_data, window=pp.window).numpy(),
        np.asarray(RREF.window_base_ref(qh, ql, rp.skhi, rp.sklo, rp.spos,
                                        eps_eff=rp.eps_eff, n_data=rp.n_data,
                                        window=rp.window)))
    assert np.array_equal(
        TREF.lower_bound_ref(qt, pp.dk).numpy(),
        np.asarray(RREF.lower_bound_ref(qh, ql, rp.dhi, rp.dlo)))


@pytest.mark.parametrize("window", [128, 256])
@pytest.mark.parametrize("mode", ["count", "bisect"])
def test_bounded_search_matches_reference(mode, window):
    """K4 on windows read from the plane equals the reference's kernel on
    the same windows gathered ahead, and the dense lower bound."""
    rng = np.random.default_rng(5)
    n, b = 8_192, 512
    keys = np.sort(rng.integers(0, 1 << 40, n, dtype=np.uint64))
    q = np.concatenate([keys[rng.integers(0, n, b - 128)],
                        rng.integers(keys[0], keys[-1], 128,
                                     dtype=np.uint64)])
    want = np.searchsorted(keys, q, side="left")
    base = np.clip(want - rng.integers(0, window // 2, b), 0,
                   n - window).astype(np.int32)
    kh, kl = split_u64(keys)
    idx = base[:, None] + np.arange(window)
    qh, ql = map(jnp.asarray, split_u64(q))
    ref = np.asarray(r_bounded_search(qh, ql, jnp.asarray(kh[idx]),
                                      jnp.asarray(kl[idx]),
                                      jnp.asarray(base)))
    dk = torch.from_numpy(to_biased(keys))
    qt = torch.from_numpy(to_biased(q))
    before = BS.launches
    got = BS.bounded_search(dk, qt, torch.from_numpy(base), window=window,
                            mode=mode)
    assert BS.launches == before and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, TREF.lower_bound_ref(qt, dk))


def test_radix_prefix_past_the_end_is_saturated():
    """Keys over a narrow span (2^26 above 2^40), radix width 8, shift 18:
    for a key far past the last one the reference keeps the low 32 bits of
    ``(q - min) >> 18`` (2^46 and more), which wraps to an arbitrary bucket,
    and both its device pipelines answer wrong ranks (ROADMAP queue 3, R5).
    The port clips the whole prefix to the last bucket and answers
    searchsorted; for every key up to the last the window bases are the
    reference's, bit for bit."""
    rng = np.random.default_rng(6)
    keys = np.unique((1 << 40) + rng.integers(0, 1 << 26, 20_000,
                                              dtype=np.uint64))
    px = _forced(keys, 8, "radix")
    assert px.layer.shift == 18
    far = np.asarray([U64_MAX, U64_MAX - (1 << 40), 1 << 63,
                      int(keys[-1]) + (1 << 52)], dtype=np.uint64)
    q = np.concatenate([far, keys[rng.integers(0, keys.size, 1_000)],
                        rng.integers(keys[0], keys[-1], 200,
                                     dtype=np.uint64)])
    want = np.searchsorted(keys, q, "left")
    from repro_torch.core import LearnedIndex
    port = LearnedIndex(plex=_port_plex(px), device="cpu")
    assert np.array_equal(port.lookup(q), want)
    for mode in SEG.SEARCH_FORMS:
        pp = _port_planes(px, mode)
        got = SEG.window_base(pp, torch.from_numpy(to_biased(q))).numpy()
        ref = _reference_bases(px, q, "bisect" if mode == "adaptive" else mode)
        assert np.array_equal(got[far.size:], ref[far.size:])
        assert not np.array_equal(got[:far.size], ref[:far.size])
    # the reference's fault (R5); if this starts to pass, R5 was fixed
    for impl in (RDevicePlex.from_plex(px, block=BLOCK),
                 JnpPlex.from_plex(px, block=BLOCK)):
        assert not np.array_equal(impl.lookup(far), want[:far.size])


def test_wrappers_refuse_other_devices(keys):
    px = _forced(keys, 16, "cht")
    pp = TP.build_planes(_port_plex(px), "cpu")
    q = torch.from_numpy(to_biased(keys[:256]))
    with pytest.raises(ValueError, match="planes on"):
        SEG.window_base(pp, q.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        BS.bounded_search(pp.dk.to("meta"), q.to("meta"),
                          torch.zeros(256, dtype=torch.int32, device="meta"),
                          window=pp.window)
    with pytest.raises(ValueError, match="probe mode"):
        BS.bounded_search(pp.dk, q, torch.zeros(256, dtype=torch.int32),
                          window=pp.window, mode="scan")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["radix", "cht"])
def test_segment_kernel_matches_plain_on_card(kind, keys):
    """On a CUDA card: K2/K3 against the plain version on the same device
    inputs, every search form and the card's default, alone and fused with
    K4, exactly (``python3 chip_smoke.py`` does the same at 2^24 keys)."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    px = _forced(keys, 8, kind)
    pp = TP.build_planes(_port_plex(px), dev)
    q = torch.from_numpy(to_biased(_queries(keys, rng))).to(dev)
    want = SEG.window_base_plain(pp, q)
    for mode in (None, *SEG.SEARCH_FORMS):
        before = SEG.launches
        got = SEG.window_base(pp, q, mode)
        assert SEG.launches == before + 1
        assert torch.equal(got, want)
        before = SEG.fused_launches
        got = SEG.window_probe(pp, q, mode)
        assert SEG.fused_launches == before + 1
        assert torch.equal(got, SEG.window_probe_plain(pp, q))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["count", "bisect"])
def test_bounded_search_kernel_matches_plain_on_card(mode, keys):
    dev = _cuda()
    rng = np.random.default_rng(8)
    pp = TP.build_planes(_port_plex(_forced(keys, 8, "radix")), dev)
    q = torch.from_numpy(to_biased(_queries(keys, rng))).to(dev)
    base = SEG.window_base(pp, q)
    before = BS.launches
    got = BS.bounded_search(pp.dk, q, base, window=pp.window, mode=mode)
    assert BS.launches == before + 1
    want = BS.probe_lower_bound(pp.dk, q, base.long(), window=pp.window,
                                mode=mode).int()
    assert torch.equal(got, want)
