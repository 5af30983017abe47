"""Device planes of the stacked lookup pipeline (the port of
``repro.kernels.planes``).

A host-built ``PLEX`` is converted once into biased int64 key planes
(``keys.py``), a float32 rank plane, max-key-padded data planes and the
static search parameters (eps slack, window geometry, layer mode). Every
contract of the reference is kept:

* the eps slack ``ceil(max_span * 2^-22) + 2`` and
  ``window = round_up(2 * eps_eff + 2, 128)``;
* the float32 rank plane holds < 2^24 positions;
* the global index plane is int32, so ``n_real_total < 2^31``;
* windows at most ``COUNT_MODE_MAX`` wide search by compare-and-count;
* spline, data and delta planes are padded with the max key.

Single index (``build_planes`` -> ``PlexPlanes``, consumed by
``ops.DevicePlex``): one spline-key plane, one rank plane, one data plane and
the layer array (radix ``table`` or CHT ``cells``) of one PLEX.

Key summary (``KeySummary``, both layouts): every 8th and every 64th key of
each data-plane row, sampled from the row's start and built on the device by
a strided copy whenever the planes are. It is derived, not one of the
reference's planes: the eps probe bisects it in L2 and then reads the one
64-byte segment of the data plane that holds the answer
(``bounded_search.summary_lower_bound``). ``summary_levels`` says how many of
its levels the probe descends.

Stacked layout (multi-shard serving): per-shard planes are padded to the max
shard size and stored flattened shard-major (``[S * n_spline_max]`` /
``[S * n_data_max]``), so a query routed to shard ``s`` gathers at
``s * row_len + local``. Genuinely per-shard scalars (radix shift, min key,
table extent; CHT delta) become ``[S]`` parameter planes; window geometry
takes the max over shards. Shards whose layers cannot be unified (mixed
radix/CHT kinds, or CHT shards with different radix widths) or a global key
count past int32 make ``build_stacked_planes`` return ``None``, and the
service serves shard by shard instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..core.cht import CHT
from ..core.plex import PLEX
from ..core.radix_table import RadixTable
from .keys import MAX_BIASED, to_biased

COUNT_MODE_MAX = 512    # windows at most this wide use compare-and-count
# keys a summary sample stands for: one 64-byte segment (kSegment in
# csrc/plex_device.cuh)
SUMMARY_STRIDE = 8
# the card's L2 (H100: 50 MB). A one-level summary (8 B per 8 keys) is kept
# only while it fits in half of it, so that it stays resident beside the
# spline planes and the data segments streaming past (PERF.md)
L2_BYTES = 50 * 10 ** 6


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_queries(q: np.ndarray, block: int) -> tuple[np.ndarray, int]:
    """Pad a query batch to a block multiple by repeating the last query.

    Returns (padded queries, original batch size)."""
    q = np.asarray(q, dtype=np.uint64)
    b = q.size
    bp = round_up(max(b, block), block)
    if bp > b:
        q = np.concatenate([q, np.repeat(q[-1:], bp - b)])
    return q, b


def finalize_indices(out, n_queries: int, n_real: int) -> np.ndarray:
    """Strip padding lanes and clamp past-the-end absent-key results to
    ``n_real``. ``out`` may be a tensor on any device."""
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return np.minimum(np.asarray(out)[:n_queries].astype(np.int64), n_real)


def summary_levels(n_keys: int) -> int:
    """Summary levels the eps probe descends over an index of ``n_keys``
    keys, all of whose planes share the card's L2: one (every 8th key,
    ``n_keys`` bytes) while that fits in half of L2, else two (every 64th
    key first, then one 64-byte segment of the 8th-key level)."""
    return 1 if n_keys <= L2_BYTES // 2 else 2


@dataclasses.dataclass(frozen=True)
class KeySummary:
    """Every ``SUMMARY_STRIDE``-th key (``l1``) and every
    ``SUMMARY_STRIDE ** 2``-th key (``l2``) of each ``row``-key row of a
    data plane, each row sampled from its own start and stored row-major
    (``[rows * ceil(row / 8)]``, ``[rows * ceil(row / 64)]``); ``levels``
    is how many of them the probe descends (``summary_levels``)."""
    l1: torch.Tensor          # biased int64
    l2: torch.Tensor          # biased int64
    row: int
    levels: int

    @property
    def n1(self) -> int:
        """Level-1 samples a row."""
        return -(-self.row // SUMMARY_STRIDE)

    @property
    def n2(self) -> int:
        """Level-2 samples a row."""
        return -(-self.row // SUMMARY_STRIDE ** 2)

    @property
    def nbytes(self) -> int:
        return (self.l1.numel() + self.l2.numel()) * 8


def build_summary(dk: torch.Tensor, row: int, levels: int) -> KeySummary:
    """The summary of the flat data plane ``dk`` of ``row``-key rows, by a
    strided copy on ``dk``'s device."""
    if levels not in (1, 2):
        raise ValueError(f"a summary has 1 or 2 levels, not {levels}")
    if row < 1 or dk.numel() % row:
        raise ValueError(f"{dk.numel()} keys are not rows of {row}")
    rows = dk.view(-1, row)
    return KeySummary(
        l1=rows[:, ::SUMMARY_STRIDE].contiguous().view(-1),
        l2=rows[:, ::SUMMARY_STRIDE ** 2].contiguous().view(-1),
        row=int(row), levels=int(levels))


@dataclasses.dataclass
class _HostStatics:
    """The scalar half of ``_HostPlanes``: everything derivable without
    touching the bulk key array."""
    kind: str
    layer_np: dict[str, np.ndarray]
    static: dict[str, Any]
    eps_eff: int
    window: int
    n_data: int
    n_real: int


@dataclasses.dataclass
class _HostPlanes:
    """Host-side (numpy) planes + static params for one PLEX."""
    sk: np.ndarray            # biased int64 spline keys
    spos: np.ndarray          # float32 spline ranks
    dk: np.ndarray            # biased int64 data keys, max-key padded
    n_data: int
    n_real: int
    kind: str
    layer_np: dict[str, np.ndarray]
    static: dict[str, Any]
    eps_eff: int
    window: int


def _host_statics(px: PLEX) -> _HostStatics:
    """Static search parameters of one PLEX (no plane construction).

    Float32 interpolation cannot reproduce float64 predictions bit for bit,
    so the eps window is widened by a static ``slack`` (2 + max segment
    position span * 2^-22, covering worst-case f32 rounding of
    ``y0 + t*(y1-y0)``).
    """
    if px.spline.positions.size and px.spline.positions[-1] >= (1 << 24):
        raise ValueError("float32 rank plane supports < 2^24 positions; "
                         "shard the index first (serving does)")
    spans = np.diff(px.spline.positions)
    max_span = int(spans.max()) if spans.size else 1
    slack = int(np.ceil(max_span * 2.0 ** -22)) + 2
    eps_eff = px.eps + slack
    window = round_up(2 * eps_eff + 2, 128)
    n_real = px.keys.size
    n_pad = max(round_up(n_real, 128), window)

    if isinstance(px.layer, RadixTable):
        kind = "radix"
        layer_np = {"table": np.asarray(px.layer.table)}
        max_win = px.layer.max_window
        static = dict(shift=int(px.layer.shift), r=int(px.layer.r),
                      min_key=int(to_biased(
                          np.asarray([px.layer.min_key]))[0]),
                      max_win=int(max_win),
                      mode="count" if max_win <= COUNT_MODE_MAX
                      else "bisect")
    elif isinstance(px.layer, CHT):
        kind = "cht"
        layer_np = {"cells": np.asarray(px.layer.cells)}
        static = dict(r=int(px.layer.r),
                      levels=int(px.layer.max_depth) + 1,
                      delta=int(px.layer.delta),
                      mode="count" if px.layer.delta + 1 <= COUNT_MODE_MAX
                      else "bisect")
    else:
        raise TypeError(f"unknown layer {type(px.layer).__name__}")
    return _HostStatics(kind=kind, layer_np=layer_np, static=static,
                        eps_eff=eps_eff, window=window, n_data=n_pad,
                        n_real=n_real)


def _spline_planes(keys: np.ndarray, positions: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Biased spline-key plane and float32 rank plane of one spline."""
    sk = to_biased(keys)
    spos = np.asarray(positions).astype(np.float32)
    if sk.size == 1:
        # every key of the shard is equal: a one-point spline has no
        # segment, and the clip to [0, n_spline - 2] would gather index -1,
        # another shard's row (the reference does, ROADMAP queue 3, R4).
        # A doubled point is a zero-width segment predicting its own rank.
        sk, spos = np.repeat(sk, 2), np.repeat(spos, 2)
    return sk, spos


def _data_plane(keys: np.ndarray, n_data: int) -> np.ndarray:
    """Biased data plane of ``keys``, max-key padded to ``n_data``."""
    dk = np.full(n_data, MAX_BIASED, dtype=np.int64)
    np.bitwise_xor(keys, np.uint64(1 << 63),
                   out=dk[:len(keys)].view(np.uint64))
    return dk


def _host_planes(px: PLEX) -> _HostPlanes:
    """Host PLEX -> host plane arrays + static search parameters."""
    hs = _host_statics(px)            # includes the f32 rank-plane guard
    sk, spos = _spline_planes(px.spline.keys, px.spline.positions)
    return _HostPlanes(sk=sk, spos=spos,
                       dk=_data_plane(px.keys, hs.n_data), n_data=hs.n_data,
                       n_real=hs.n_real, kind=hs.kind, layer_np=hs.layer_np,
                       static=hs.static, eps_eff=hs.eps_eff,
                       window=hs.window)


# -- persisted statics (the snapshot file's header, ``persist.format``) -------
#
# A snapshot file holds the reference's statics, byte for byte, so that each
# package opens the other's generations. They differ from the port's in the
# radix minimum only: the reference keeps its two 32-bit words ``min_hi`` and
# ``min_lo``, the port one biased ``min_key``.

def persisted_static(hs: _HostStatics) -> dict[str, Any]:
    """``hs.static`` in the reference's form: the same keys, in the same
    order, so that ``json.dumps`` gives the reference's bytes."""
    s = hs.static
    if hs.kind != "radix":
        return dict(s)
    mk = int(s["min_key"]) + (1 << 63)            # the unbiased u64 minimum
    return dict(shift=s["shift"], r=s["r"], min_hi=(mk >> 32) & 0xFFFFFFFF,
                min_lo=mk & 0xFFFFFFFF, max_win=s["max_win"],
                mode=s["mode"])


def _port_static(kind: str, static: dict[str, Any]) -> dict[str, Any]:
    """Inverse of ``persisted_static``."""
    if kind != "radix":
        return dict(static)
    mk = (int(static["min_hi"]) << 32) | int(static["min_lo"])
    return dict(shift=int(static["shift"]), r=int(static["r"]),
                min_key=mk - (1 << 63), max_win=int(static["max_win"]),
                mode=static["mode"])


def _host_planes_from_mapped(meta: dict[str, Any], keys: np.ndarray,
                             spline_keys: np.ndarray,
                             spline_positions: np.ndarray,
                             layer: np.ndarray) -> _HostPlanes:
    """One shard's ``_HostPlanes`` from a snapshot file's mapped planes and
    its header entry ``meta`` (the persisted statics): the warm path,
    which derives nothing the file holds. Only the port's own planes are
    made here: the biased key planes (the data plane is the one O(n) host
    pass, its padding by ``meta["n_data"]``) and the float32 rank plane; a
    one-point spline is doubled in memory as in ``_host_planes`` (R4)."""
    sk, spos = _spline_planes(spline_keys, spline_positions)
    name = "table" if meta["kind"] == "radix" else "cells"
    return _HostPlanes(
        sk=sk, spos=spos, dk=_data_plane(keys, int(meta["n_data"])),
        n_data=int(meta["n_data"]), n_real=int(meta["n_real"]),
        kind=meta["kind"], layer_np={name: layer},
        static=_port_static(meta["kind"], meta["static"]),
        eps_eff=int(meta["eps_eff"]), window=int(meta["window"]))


@dataclasses.dataclass
class PlexPlanes:
    """Device planes of one PLEX (the reference's ``PlexPlanes``)."""
    sk: torch.Tensor          # biased int64 spline keys [n_spline]
    spos: torch.Tensor        # float32 spline ranks [n_spline]
    dk: torch.Tensor          # biased int64 data keys, max-key padded [n_data]
    n_data: int               # padded length
    n_real: int
    kind: str                 # "radix" | "cht"
    layer_arrays: dict[str, torch.Tensor]   # int32 "table" | int32 "cells"
    static: dict[str, Any]
    eps_eff: int
    window: int
    summary: KeySummary       # derived from dk on the device

    @property
    def device(self) -> torch.device:
        return self.dk.device


def build_planes(px: PLEX, device) -> PlexPlanes:
    """Host PLEX -> ``PlexPlanes`` on ``device``, with the data plane's key
    summary. A one-point spline is doubled (see ``_host_planes``), so
    ``n_spline >= 2``."""
    hp = _host_planes(px)
    if hp.kind == "radix":
        layer = {"table": hp.layer_np["table"].astype(np.int32)}
    else:
        if (hp.static["levels"] - 1) * hp.static["r"] >= 64:
            raise ValueError("CHT descends past 64 key bits")
        # uint32 cells (top bit = child flag) reinterpreted as int32
        layer = {"cells": hp.layer_np["cells"].astype(np.uint32)
                 .view(np.int32)}

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    dk = put(hp.dk)
    return PlexPlanes(sk=put(hp.sk), spos=put(hp.spos), dk=dk,
                      n_data=hp.n_data, n_real=hp.n_real, kind=hp.kind,
                      layer_arrays={k: put(v) for k, v in layer.items()},
                      static=dict(hp.static), eps_eff=hp.eps_eff,
                      window=hp.window,
                      summary=build_summary(dk, hp.n_data,
                                            summary_levels(hp.n_data)))


@dataclasses.dataclass
class DeltaPlanes:
    """Device-resident sorted delta buffer (updatable serving).

    The logical content is a sorted multiset of (key, signed weight)
    entries: ``+1`` per live inserted key, ``-multiplicity`` per tombstoned
    snapshot key. ``cum0`` is the exclusive prefix sum of the weights
    (length ``cap + 1``, leading 0), so the merged-lookup rank adjustment
    for a query ``q`` is ``cum0[# delta keys < q]``. Pad keys are the max
    key with weight 0, so padding never perturbs the adjustment.
    """
    keys: torch.Tensor        # biased int64 [cap]
    cum0: torch.Tensor        # int32 [cap + 1], exclusive weight prefix
    cap: int
    n_entries: int            # real (unpadded) entries


def build_delta_planes(keys: np.ndarray, weights: np.ndarray, cap: int,
                       device) -> DeltaPlanes:
    """Sorted delta entries -> padded device planes (see ``DeltaPlanes``)."""
    keys = np.asarray(keys, dtype=np.uint64)
    weights = np.asarray(weights, dtype=np.int64)
    if keys.size > cap:
        raise ValueError(f"delta size {keys.size} exceeds capacity {cap}")
    if np.any(keys[1:] < keys[:-1]):
        raise ValueError("delta keys must be sorted")
    kb = np.full(cap, MAX_BIASED, dtype=np.int64)
    kb[:keys.size] = to_biased(keys)
    cum0 = np.zeros(cap + 1, dtype=np.int64)
    np.cumsum(weights, out=cum0[1:keys.size + 1])
    cum0[keys.size + 1:] = cum0[keys.size]
    if np.abs(cum0).max(initial=0) >= (1 << 31):
        raise ValueError("delta weight prefix exceeds int32 range")
    return DeltaPlanes(keys=torch.from_numpy(kb).to(device),
                       cum0=torch.from_numpy(cum0.astype(np.int32)).to(device),
                       cap=int(cap), n_entries=int(keys.size))


@dataclasses.dataclass
class StackedPlanes:
    """Shard-major fused planes of several shard-local PLEX indexes (layout
    in the module docstring), consumed by ``stacked_lookup``."""
    # spline planes, [S * n_spline_max] row-major flat
    sk: torch.Tensor          # biased int64
    spos: torch.Tensor        # float32
    # data plane, [S * n_data_max] row-major flat
    dk: torch.Tensor          # biased int64
    # per-shard geometry planes, [S]
    n_spline: torch.Tensor    # int32 real spline points per shard
    n_real: torch.Tensor      # int32 real keys per shard
    row_off: torch.Tensor     # int32 global key offset per shard
    shard_min: torch.Tensor   # biased int64 routing plane: first key per shard
    # shapes / unified statics
    n_shards: int
    n_spline_max: int
    n_data_max: int
    n_real_total: int
    kind: str                 # "radix" | "cht"
    layer_arrays: dict[str, torch.Tensor]
    static: dict[str, Any]
    eps_eff: int              # max over shards
    window: int               # max over shards
    summary: KeySummary       # derived from dk on the device, row by row

    @property
    def device(self) -> torch.device:
        return self.dk.device


def _unify_gate(hss: Sequence[_HostStatics | _HostPlanes],
                row_off: np.ndarray) -> bool:
    """Whether shards of these statics, at global key offsets ``row_off``,
    stack into one layout: one layer kind, one radix width among CHT
    shards, and a global key count below 2^31."""
    if len({hs.kind for hs in hss}) != 1:
        return False
    if hss[0].kind == "cht" and len({hs.static["r"] for hs in hss}) != 1:
        return False
    return int(row_off[-1]) + hss[-1].n_real < (1 << 31)


def shards_unify(plexes: Sequence[PLEX], row_off: np.ndarray) -> bool:
    """``build_stacked_planes``' unification gate alone, from the shards'
    statics (no plane is built)."""
    return _unify_gate([_host_statics(px) for px in plexes], row_off)


def build_stacked_planes(plexes: Sequence[PLEX], row_off: np.ndarray,
                         device, host_planes: Sequence[_HostPlanes] | None
                         = None, summary_keys: int | None = None
                         ) -> StackedPlanes | None:
    """Fuse shard-local PLEX indexes into one ``StackedPlanes`` on
    ``device``, or ``None`` when they cannot be unified (see the module
    docstring). ``row_off[s]`` is shard ``s``'s global key offset.
    ``summary_keys`` is the size of the index whose planes share the card
    with these (a service's whole snapshot when each shard has planes of its
    own); it sets the summary's levels and defaults to these planes' keys."""
    # the gates read statics only: no bulk plane is built for shards that
    # do not unify
    hss = (list(host_planes) if host_planes is not None
           else [_host_statics(px) for px in plexes])
    if not _unify_gate(hss, row_off):
        return None
    kind = hss[0].kind
    n_real_total = int(row_off[-1]) + hss[-1].n_real
    hps = (list(host_planes) if host_planes is not None
           else [_host_planes(px) for px in plexes])

    s_count = len(hps)
    eps_eff = max(hp.eps_eff for hp in hps)
    window = max(hp.window for hp in hps)
    n_spline_max = max(hp.sk.size for hp in hps)
    n_data_max = max(max(hp.n_data for hp in hps), window)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def flat(arrays, n: int, dtype, fill) -> np.ndarray:
        out = np.empty((len(arrays), n), dtype=dtype)
        for row, a in zip(out, arrays):
            row[:a.size] = a
            row[a.size:] = a[-1] if fill is None else fill
        return out.reshape(-1)

    sk = flat([hp.sk for hp in hps], n_spline_max, np.int64, MAX_BIASED)
    # the rank-plane pad repeats the last rank (never read: segments are
    # clamped to n_spline - 2 before interpolation)
    spos = flat([hp.spos for hp in hps], n_spline_max, np.float32, None)
    dk = flat([hp.dk for hp in hps], n_data_max, np.int64, MAX_BIASED)
    mins = to_biased(np.asarray([px.keys[0] for px in plexes], np.uint64))

    if kind == "radix":
        tables = [hp.layer_np["table"] for hp in hps]
        sizes = np.asarray([t.size for t in tables], dtype=np.int64)
        table_off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        max_win = max(hp.static["max_win"] for hp in hps)
        layer_arrays = {
            "table": put(np.concatenate(tables).astype(np.int32)),
            "table_off": put(table_off.astype(np.int32)),
            "shift": put(np.asarray([hp.static["shift"] for hp in hps],
                                    np.int32)),
            "p_max": put(np.asarray([(1 << hp.static["r"]) - 1
                                     for hp in hps], np.int32)),
            "lmin": put(np.asarray([hp.static["min_key"] for hp in hps],
                                   np.int64)),
        }
        static = dict(max_win=int(max_win),
                      mode="count" if max_win <= COUNT_MODE_MAX
                      else "bisect")
    else:
        cells = [hp.layer_np["cells"] for hp in hps]
        sizes = np.asarray([c.size for c in cells], dtype=np.int64)
        cells_off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        delta_max = max(hp.static["delta"] for hp in hps)
        levels = max(hp.static["levels"] for hp in hps)
        r = int(hps[0].static["r"])
        if (levels - 1) * r >= 64:
            raise ValueError("CHT descends past 64 key bits")
        layer_arrays = {
            # uint32 cells (top bit = child flag) reinterpreted as int32
            "cells": put(np.concatenate(cells).astype(np.uint32)
                         .view(np.int32)),
            "cells_off": put(cells_off.astype(np.int32)),
            "delta": put(np.asarray([hp.static["delta"] for hp in hps],
                                    np.int32)),
        }
        static = dict(r=r, levels=levels, delta_max=int(delta_max),
                      mode="count" if delta_max + 1 <= COUNT_MODE_MAX
                      else "bisect")

    dk = put(dk)
    n_summary = s_count * n_data_max if summary_keys is None else summary_keys
    return StackedPlanes(
        sk=put(sk), spos=put(spos), dk=dk,
        n_spline=put(np.asarray([hp.sk.size for hp in hps], np.int32)),
        n_real=put(np.asarray([hp.n_real for hp in hps], np.int32)),
        row_off=put(np.asarray(row_off, np.int32)),
        shard_min=put(mins),
        n_shards=s_count, n_spline_max=n_spline_max, n_data_max=n_data_max,
        n_real_total=n_real_total, kind=kind, layer_arrays=layer_arrays,
        static=static, eps_eff=eps_eff, window=window,
        summary=build_summary(dk, n_data_max, summary_levels(n_summary)))
