"""The port's plain stacked pipeline against the reference, exactly.

Ranks, routed shard ids and local window bases of
``repro_torch.kernels.stacked_lookup`` are held against the reference's jnp
pipeline (``jnp_lookup._stacked_pipeline_aux`` and the
``plex_segment_lookup.stacked_*_window_base`` bodies the Pallas kernel runs)
over the variant matrix {radix, CHT} x {spline count, bisect} x {probe
count, bisect} x {no delta, live delta}, plus one case through the Pallas
kernel itself in interpret mode. The plain version refuses out-of-bounds
gathers, so every case also shows that no gather leaves its plane.

The port's radix prefix saturates where the reference's wraps (ROADMAP queue
3, R5): queries whose prefix on their shard reaches 2^31 (keys far past the
end of a narrow radix shard) are held to ``np.searchsorted`` over the
logical keys instead, and every other query to the reference bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import jnp_lookup as RJ
from repro.kernels import planes as RP
from repro.kernels import plex_segment_lookup as RS
from repro.kernels.pairs import extract_bits, split_u64
from repro.kernels.stacked_pallas import stacked_pallas_lookup
from repro.serving.delta import DeltaBuffer as RDelta
from repro_torch.kernels import planes as TP
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.keys import from_biased, to_biased
from repro_torch.serving.delta import DeltaBuffer as TDelta

from conftest import sorted_u64
from test_torch_planes import _port_plex

U64_MAX = (1 << 64) - 1


@pytest.fixture(scope="module")
def keys():
    """Two wide shards (keys over 2^62, with duplicates) and a narrow one
    (a 2^28 span above 2^63): its small radix shift makes a huge absent
    query's prefix wrap negative, the case the prefix clip exists for."""
    rng = np.random.default_rng(7)
    wide = sorted_u64(rng, 16_000, dups=True)
    narrow = np.sort((1 << 63) + rng.integers(0, 1 << 28, 8_000,
                                              dtype=np.uint64))
    return np.concatenate([wide, narrow])


@pytest.fixture(scope="module")
def offs(keys):
    raw = np.asarray([0, 7_000, 16_000])
    return np.searchsorted(keys, keys[raw], "left")


def _forced(keys, offs, kind):
    """Shard PLEXes with a forced layer (differing per-shard parameters:
    radix widths and shifts, CHT deltas and depths)."""
    ends = np.append(offs[1:], keys.size)
    out = []
    for i, (lo, hi) in enumerate(zip(offs, ends)):
        px = R.build_plex(keys[lo:hi], 16)
        layer = (R.build_radix_table(px.spline.keys, 5 + 2 * i)
                 if kind == "radix"
                 else R.build_cht(px.spline.keys, 3, 6 + 8 * i))
        out.append(dataclasses.replace(px, layer=layer))
    return out


def _queries(keys, offs, rng, extra=()):
    mins = keys[offs]
    edges = np.asarray([0, 1, int(keys[0]), int(keys[-1]), int(keys[-1]) + 1,
                        U64_MAX, U64_MAX - 1, 1 << 63, (1 << 63) - 1],
                       dtype=np.uint64)
    special = np.concatenate([edges, mins, mins - np.uint64(1),
                              mins + np.uint64(1)])
    return np.concatenate([
        special, np.asarray(extra, np.uint64),
        keys[rng.integers(0, keys.size, 1_500)],
        rng.integers(0, U64_MAX, 400, dtype=np.uint64, endpoint=True),
        rng.integers(keys[0], keys[-1], 400, dtype=np.uint64)])


def _reference(sp, probe, q, dp):
    """(ranks, shard ids, local window bases) from the reference jnp
    pipeline on the same planes."""
    s, la = sp.static, sp.layer_arrays

    def fn(qhi, qlo, *delta):
        res, sid, _ = RJ._stacked_pipeline_aux(sp, probe, qhi, qlo)
        if sp.kind == "radix":
            base = RS.stacked_radix_window_base(
                qhi, qlo, sid, la["table"], la["table_off"], la["shift"],
                la["p_max"], la["lmin_hi"], la["lmin_lo"], sp.skhi,
                sp.sklo, sp.spos, sp.n_spline, n_spline_max=sp.n_spline_max,
                max_win=s["max_win"], eps_eff=sp.eps_eff,
                n_data_max=sp.n_data_max, window=sp.window, mode=s["mode"])
        else:
            bins = jnp.stack([extract_bits(qhi, qlo, lvl * s["r"], s["r"])
                              for lvl in range(s["levels"])])
            base = RS.stacked_cht_window_base(
                qhi, qlo, sid, bins, la["cells"], la["cells_off"],
                la["delta"], sp.skhi, sp.sklo, sp.spos, sp.n_spline,
                r=s["r"], levels=s["levels"], delta_max=s["delta_max"],
                n_spline_max=sp.n_spline_max, eps_eff=sp.eps_eff,
                n_data_max=sp.n_data_max, window=sp.window, mode=s["mode"])
        if delta:
            res = res + RJ.delta_rank_adjust(qhi, qlo, *delta, cap=dp.cap)
        return res, sid, base

    qh, ql = split_u64(q)
    args = [jnp.asarray(qh), jnp.asarray(ql)]
    if dp is not None:
        args += [dp.khi, dp.klo, dp.cum0]
    return tuple(np.asarray(a).astype(np.int64)
                 for a in jax.jit(fn)(*args))


def _wrapped(tsp, q):
    """Queries whose radix prefix ``(q - min) >> shift`` on their routed
    shard reaches 2^31: there the reference's low-32-bit prefix wraps and
    the port's saturates (R5). None on a CHT layer."""
    if tsp.kind != "radix":
        return np.zeros(q.size, dtype=bool)
    mins = from_biased(tsp.shard_min.numpy())
    sid = np.clip(np.searchsorted(mins, q, "right") - 1, 0, mins.size - 1)
    lmin = from_biased(tsp.layer_arrays["lmin"].numpy())[sid]
    shift = tsp.layer_arrays["shift"].numpy()[sid]
    return np.asarray([x >= m and (int(x) - int(m)) >> int(k) >= 1 << 31
                       for x, m, k in zip(q, lmin, shift)], dtype=bool)


def _port(tsp, probe, q, tdp):
    out, sid, base = SL.stacked_lookup(
        tsp, probe, torch.from_numpy(to_biased(q)), tdp, aux=True)
    return tuple(a.numpy().astype(np.int64) for a in (out, sid, base))


def _delta(keys, rng):
    """The same live delta in both packages: inserts (some duplicates of
    snapshot keys), deletes of present keys, a re-insert of a deleted one."""
    ins = np.concatenate([rng.integers(keys[0], keys[-1], 300,
                                       dtype=np.uint64),
                          keys[rng.integers(0, keys.size, 40)]])
    dels = keys[rng.integers(0, keys.size, 120)]
    bufs = [RDelta(keys, capacity=1024), TDelta(keys, capacity=1024)]
    for b in bufs:
        b.insert(ins)
        b.delete(dels)
        b.insert(dels[:5])
    return bufs[0].device_view(), bufs[1].device_view("cpu"), \
        np.concatenate([ins, dels]), bufs[1].logical_keys()


@pytest.mark.parametrize("fold", [False, True], ids=["cap0", "delta"])
@pytest.mark.parametrize("probe", ["count", "bisect"])
@pytest.mark.parametrize("spline_mode", ["count", "bisect"])
@pytest.mark.parametrize("kind", ["radix", "cht"])
def test_variant_matrix_matches_reference(kind, spline_mode, probe, fold,
                                          keys, offs):
    rng = np.random.default_rng(11)
    pxs = _forced(keys, offs, kind)
    sp = RP.build_stacked_planes(pxs, offs)
    tsp = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    assert sp.kind == tsp.kind == kind
    sp.static["mode"] = tsp.static["mode"] = spline_mode
    if kind == "cht":
        assert len(set(np.asarray(sp.layer_arrays["delta"]))) == 3
    rdp = tdp = None
    extra = ()
    logical = keys
    if fold:
        rdp, tdp, extra, logical = _delta(keys, rng)
    q = _queries(keys, offs, rng, extra)
    want = _reference(sp, probe, q, rdp)
    got = _port(tsp, probe, q, tdp)
    wrap = _wrapped(tsp, q)
    assert wrap.any() == (kind == "radix")
    for name, g, w in zip(("ranks", "shard ids", "window bases"), got, want):
        assert np.array_equal(g[~wrap], w[~wrap]), \
            (name, np.flatnonzero(g[~wrap] != w[~wrap])[:5])
    assert np.array_equal(got[1][wrap], want[1][wrap])
    assert np.array_equal(got[0][wrap],
                          np.searchsorted(logical, q[wrap], "left"))


def test_fused_pallas_kernel_interpret(keys, offs):
    """One case through the reference's fused Pallas kernel itself
    (interpret mode), merged with a live delta."""
    rng = np.random.default_rng(5)
    pxs = _forced(keys, offs, "radix")
    sp = RP.build_stacked_planes(pxs, offs)
    tsp = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    rdp, tdp, extra, logical = _delta(keys, rng)
    q, n = RP.pad_queries(_queries(keys, offs, rng, extra)[:1_000], 512)
    qh, ql = split_u64(q)
    want = stacked_pallas_lookup(
        sp, "bisect", rdp.cap, jnp.asarray(qh), jnp.asarray(ql), rdp.khi,
        rdp.klo, rdp.cum0, block=512, interpret=True)
    got = _port(tsp, "bisect", q, tdp)[0]
    wrap = _wrapped(tsp, q)
    assert wrap.any()
    assert np.array_equal(got[~wrap],
                          np.asarray(want).astype(np.int64)[~wrap])
    assert np.array_equal(got[wrap],
                          np.searchsorted(logical, q[wrap], "left"))


@pytest.mark.parametrize("name", ["face", "osm", "wiki"])
def test_tuned_snapshot_matches_reference(name):
    """Tuned (not forced) shards of each dataset through the stacked impls
    of both packages; present keys equal searchsorted."""
    from repro.data import generate
    from repro_torch.core import Snapshot
    rng = np.random.default_rng(3)
    keys = generate(name, 40_000, 4)
    ref = R.Snapshot.build(keys.copy(), 32, n_shards=3)
    port = Snapshot.build(keys.copy(), 32, n_shards=3, device="cpu")
    rj = RJ.StackedJnpPlex.from_plexes([s.plex for s in ref.shards],
                                       ref.offsets, block=512,
                                       probe="bisect")
    st = port.stacked_impl(block=512)
    assert (rj is None) == (st is None)
    if st is None:
        pytest.skip("shards do not unify at this size")
    q = _queries(keys, port.offsets, rng)
    got = st.lookup(q)
    wrap = _wrapped(st.planes, q)
    assert np.array_equal(got[~wrap], rj.lookup(q)[~wrap])
    assert np.array_equal(got[wrap], np.searchsorted(keys, q[wrap], "left"))
    present = np.isin(q, keys)
    assert np.array_equal(got[present],
                          np.searchsorted(keys, q[present], "left"))


@pytest.mark.parametrize("spline_mode", ["count", "bisect"])
def test_far_past_the_end_keys_are_saturated(spline_mode):
    """Keys far past the end (2^64 - 1, 2^63, the last key + 2^52) over
    two wide shards and a narrow radix shard (a 2^26 span above 2^40, shift
    18 or so): their prefix ``(q - min) >> shift`` reaches 2^46. The
    reference keeps its low 32 bits, which lands in an arbitrary bucket, and
    its stacked path answers wrong ranks (ROADMAP queue 3, R5). The port
    saturates the prefix at the last bucket: its plain stacked pipeline, in
    both spline modes and both probes, and its ``PlexService`` on the CPU
    answer ``np.searchsorted``."""
    from repro_torch.serving.plex_service import PlexService
    rng = np.random.default_rng(9)
    keys = np.concatenate([
        sorted_u64(rng, 12_000, dups=True, spread=39),
        np.sort((1 << 40) + rng.integers(0, 1 << 26, 6_000,
                                         dtype=np.uint64))])
    offs = np.asarray([0, 6_000, 12_000])
    offs = np.searchsorted(keys, keys[offs], "left")
    far = np.asarray([U64_MAX, 1 << 63, int(keys[-1]) + (1 << 52)],
                     dtype=np.uint64)
    want = np.searchsorted(keys, far, "left")
    pxs = _forced(keys, offs, "radix")
    tsp = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    tsp.static["mode"] = spline_mode
    assert _wrapped(tsp, far).all()
    for probe in ("count", "bisect"):
        assert np.array_equal(_port(tsp, probe, far, None)[0], want)
    svc = PlexService(keys.copy(), eps=16, n_shards=3, device="cpu")
    assert svc.fused and svc.snapshot.shards[2].layer.shift <= 32
    assert np.array_equal(svc.lookup(far), want)
    # the reference's fault (R5); if this starts to pass, R5 was fixed
    ref = R.Snapshot.build(keys.copy(), 16, n_shards=3)
    rj = RJ.StackedJnpPlex.from_plexes([s.plex for s in ref.shards],
                                       ref.offsets, block=512,
                                       probe="bisect")
    assert not np.array_equal(rj.lookup(far), want)
    sp = RP.build_stacked_planes(pxs, offs)
    sp.static["mode"] = spline_mode
    assert not np.array_equal(_reference(sp, "bisect", far, None)[0], want)


@pytest.mark.parametrize("probe", ["count", "bisect"])
def test_one_point_spline_shard_is_exact(probe):
    """A shard whose keys are all equal has a one-point spline. The
    reference's device pipelines gather its segment at index -1, the row of
    the shard before, and answer 5944 for the present key 5000 below (want
    3000; ROADMAP queue 3, R4). The port doubles the point and answers
    every query exactly, with every gather in bounds."""
    from repro_torch.core import Snapshot
    rng = np.random.default_rng(0)
    keys = np.sort(np.concatenate([
        np.arange(3000, dtype=np.uint64), np.full(3000, 5000, np.uint64),
        np.unique(rng.integers(6000, 1 << 60, 3200, dtype=np.uint64))[:3000]]))
    snap = Snapshot.build(keys.copy(), 8, n_shards=3, device="cpu")
    assert [px.spline.keys.size for px in snap.shards][1] == 1
    st = snap.stacked_impl(block=128, probe=probe)
    q = np.concatenate([np.asarray([5000, 2999, 0], np.uint64), keys[::97]])
    want = np.searchsorted(keys, q, "left")
    assert np.array_equal(st.lookup(q), want)
    # the reference's fault (R4); if this starts to pass, R4 was fixed
    from repro.serving import PlexService as RService
    ref = RService(keys.copy(), eps=8, n_shards=3, block=128, probe=probe,
                   backend="jnp").lookup(q[:1])
    assert ref[0] == 5944 != want[0] == 3000
    single = Snapshot.build(np.full(500, 7, np.uint64), 8, device="cpu")
    assert single.stacked_impl(block=128).lookup(
        np.asarray([7, 0], np.uint64)).tolist() == [0, 0]


def test_dispatch_by_device(keys, offs):
    """CPU tensors take the plain version (no launch counted); a tensor on
    another device than the planes is refused."""
    pxs = _forced(keys, offs, "radix")
    tsp = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    before = SL.launches
    q = torch.from_numpy(to_biased(keys[:256]))
    out, sid, base = SL.stacked_lookup(tsp, "bisect", q)
    assert sid is None and base is None and out.dtype == torch.int32
    assert SL.launches == before
    with pytest.raises(ValueError, match="planes on"):
        SL.stacked_lookup(tsp, "bisect", q.to("meta"))


def test_plain_gather_refuses_out_of_bounds():
    plane = torch.arange(10)
    with pytest.raises(IndexError):
        SL._take(plane, torch.tensor([3, -1]))
    with pytest.raises(IndexError):
        SL._take(plane, torch.tensor([10]))
    assert SL._take(plane, torch.tensor([0, 9])).tolist() == [0, 9]


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(keys, offs):
    """On a CUDA card: the kernel against the plain version on the same
    device inputs, every variant, exactly (``python3 chip_smoke.py`` does
    the same at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)
    for kind in ("radix", "cht"):
        pxs = [_port_plex(p) for p in _forced(keys, offs, kind)]
        tsp = TP.build_stacked_planes(pxs, offs, "cuda")
        tbuf = TDelta(keys, capacity=1024)
        tbuf.insert(rng.integers(keys[0], keys[-1], 200, dtype=np.uint64))
        q = torch.from_numpy(to_biased(_queries(keys, offs, rng))).cuda()
        for mode in ("count", "bisect"):
            tsp.static["mode"] = mode
            for probe in ("count", "bisect"):
                for tdp in (None, tbuf.device_view(torch.device("cuda"))):
                    got = SL.stacked_lookup(tsp, probe, q, tdp, aux=True)
                    want = SL.stacked_lookup_plain(tsp, probe, q, tdp)
                    for g, w in zip(got, want):
                        assert torch.equal(g, w)
