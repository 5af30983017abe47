"""Port device planes against the reference's, after re-biasing.

Every plane of ``repro_torch.kernels.planes`` must equal the reference's
``repro.kernels.planes`` plane once the reference's (hi, lo) uint32 key
planes are joined and biased; statics, geometry and the unification and
range gates must agree too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import planes as RP
from repro.kernels.pairs import join_u64
from repro_torch.kernels import planes as TP
from repro_torch.kernels.keys import to_biased

from conftest import sorted_u64


def _biased(hi, lo) -> np.ndarray:
    return to_biased(join_u64(np.asarray(hi), np.asarray(lo)))


def _plexes(keys, offs, eps, kinds=None):
    """Shard PLEXes (reference build: the port's is identical, see
    test_torch_build), optionally forced to a layer kind per shard."""
    ends = np.append(offs[1:], keys.size)
    out = []
    for i, (lo, hi) in enumerate(zip(offs, ends)):
        px = R.build_plex(keys[lo:hi], eps)
        kind = None if kinds is None else kinds[i]
        if kind == "cht":
            px = dataclasses.replace(
                px, layer=R.build_cht(px.spline.keys, 4, 8 + 8 * i))
        elif kind == "radix":
            px = dataclasses.replace(
                px, layer=R.build_radix_table(px.spline.keys, 6 + i))
        out.append(px)
    return out


def _port_plex(px):
    """The same PLEX as a port object (shared arrays, port classes)."""
    import repro_torch.core as T
    sp = T.Spline(keys=px.spline.keys, positions=px.spline.positions,
                  eps=px.spline.eps, n_keys=px.spline.n_keys)
    if isinstance(px.layer, R.RadixTable):
        layer = T.RadixTable(r=px.layer.r, min_key=px.layer.min_key,
                             shift=px.layer.shift, table=px.layer.table,
                             n_keys=px.layer.n_keys)
    else:
        layer = T.CHT(r=px.layer.r, delta=px.layer.delta,
                      cells=px.layer.cells, n_nodes=px.layer.n_nodes,
                      max_depth=px.layer.max_depth, n_keys=px.layer.n_keys)
    return T.PLEX(spline=sp, layer=layer, tuning=px.tuning, keys=px.keys,
                  eps=px.eps, stats=T.BuildStats(0, 0, 0, 0))


def _assert_static_equal(got: dict, want: dict):
    want = dict(want)
    if "min_hi" in want:
        want["min_key"] = int(_biased(np.uint32(want.pop("min_hi")),
                                      np.uint32(want.pop("min_lo"))))
    assert got == want


@pytest.mark.parametrize("kind", ["radix", "cht"])
def test_host_planes_identical(kind, rng):
    keys = sorted_u64(rng, 20_000, dups=True)
    px = _plexes(keys, np.asarray([0]), 16, [kind])[0]
    want = RP._host_planes(px)
    got = TP._host_planes(_port_plex(px))
    assert np.array_equal(got.sk, _biased(want.skh, want.skl))
    assert np.array_equal(got.spos, want.spos)
    assert np.array_equal(got.dk, _biased(want.dh, want.dl))
    assert (got.n_data, got.n_real, got.kind, got.eps_eff, got.window) == \
        (want.n_data, want.n_real, want.kind, want.eps_eff, want.window)
    _assert_static_equal(got.static, want.static)
    for k, v in want.layer_np.items():
        assert np.array_equal(got.layer_np[k], v)


@pytest.mark.parametrize("kinds", [("radix",) * 3, ("cht",) * 3, None])
def test_stacked_planes_identical(kinds, rng):
    keys = sorted_u64(rng, 30_000, dups=True)
    offs = np.asarray([0, 9_000, 21_000])
    offs = np.searchsorted(keys, keys[offs], "left")
    pxs = _plexes(keys, offs, 32, kinds)
    want = RP.build_stacked_planes(pxs, offs)
    got = TP.build_stacked_planes([_port_plex(p) for p in pxs], offs, "cpu")
    assert np.array_equal(got.sk.numpy(),
                          _biased(want.skhi, want.sklo))
    assert np.array_equal(got.spos.numpy(), np.asarray(want.spos))
    assert np.array_equal(got.dk.numpy(), _biased(want.dhi, want.dlo))
    for f in ("n_spline", "n_real", "row_off"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert np.array_equal(got.shard_min.numpy(),
                          _biased(want.min_hi, want.min_lo))
    for f in ("n_shards", "n_spline_max", "n_data_max", "n_real_total",
              "kind", "static", "eps_eff", "window"):
        assert getattr(got, f) == getattr(want, f), f
    la_w = {k: np.asarray(v) for k, v in want.layer_arrays.items()}
    la_g = {k: v.numpy() for k, v in got.layer_arrays.items()}
    if got.kind == "radix":
        assert np.array_equal(la_g["lmin"],
                              _biased(la_w.pop("lmin_hi"),
                                      la_w.pop("lmin_lo")))
        la_g.pop("lmin")
    else:
        la_g["cells"] = la_g["cells"].view(np.uint32)
    assert la_g.keys() == la_w.keys()
    for k in la_w:
        assert np.array_equal(la_g[k], la_w[k].astype(la_g[k].dtype)), k
        assert la_g[k].dtype.itemsize == la_w[k].dtype.itemsize, k


@pytest.mark.parametrize("case", ["mixed_kinds", "cht_r_mismatch",
                                  "int32_gate"])
def test_unification_gates_agree(case, rng):
    keys = sorted_u64(rng, 20_000)
    offs = np.asarray([0, 10_000])
    if case == "mixed_kinds":
        pxs = _plexes(keys, offs, 32, ["radix", "cht"])
    elif case == "cht_r_mismatch":
        pxs = _plexes(keys, offs, 32, ["cht", "cht"])
        pxs[1] = dataclasses.replace(
            pxs[1], layer=R.build_cht(pxs[1].spline.keys, 5, 8))
    else:
        pxs = _plexes(keys, offs, 32)
        offs = np.asarray([0, (1 << 31) - 5_000])
    assert RP.build_stacked_planes(pxs, offs) is None
    assert TP.build_stacked_planes([_port_plex(p) for p in pxs], offs,
                                   "cpu") is None


def test_f32_rank_guard_agrees(rng):
    keys = sorted_u64(rng, 2_000)
    px = R.build_plex(keys, 16)
    big = dataclasses.replace(px.spline,
                              positions=px.spline.positions + (1 << 24))
    px = dataclasses.replace(px, spline=big)
    with pytest.raises(ValueError, match="2\\^24"):
        RP._host_statics(px)
    with pytest.raises(ValueError, match="2\\^24"):
        TP._host_statics(_port_plex(px))


def test_delta_planes_identical(rng):
    k = np.sort(rng.integers(0, np.iinfo(np.uint64).max, 300,
                             dtype=np.uint64))
    w = rng.integers(-3, 2, 300)
    want = RP.build_delta_planes(k, w, 512)
    got = TP.build_delta_planes(k, w, 512, "cpu")
    assert np.array_equal(got.keys.numpy(), _biased(want.khi, want.klo))
    assert np.array_equal(got.cum0.numpy(), np.asarray(want.cum0))
    assert (got.cap, got.n_entries) == (want.cap, want.n_entries)
    with pytest.raises(ValueError):
        TP.build_delta_planes(k, w, 256, "cpu")
    with pytest.raises(ValueError):
        TP.build_delta_planes(k[::-1], w, 512, "cpu")


def test_pad_and_finalize_identical(rng):
    q = rng.integers(0, 1 << 62, 700, dtype=np.uint64)
    for block in (128, 512, 1024):
        a, na = TP.pad_queries(q, block)
        b, nb = RP.pad_queries(q, block)
        assert na == nb and np.array_equal(a, b)
        assert np.all(a[na:] == q[-1])
    out = rng.integers(0, 2_000, 1024).astype(np.int32)
    want = RP.finalize_indices(out, 700, 1_500)
    assert np.array_equal(TP.finalize_indices(out, 700, 1_500), want)
    assert np.array_equal(TP.finalize_indices(torch.from_numpy(out), 700,
                                              1_500), want)
