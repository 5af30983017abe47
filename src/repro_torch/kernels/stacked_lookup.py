"""The fused stacked PLEX lookup: plain PyTorch version, CUDA kernel wrapper,
and ``StackedTorchPlex``, the serving impl around them.

Per query, one pass does what the reference splits over
``repro.kernels.jnp_lookup`` (``_route``, ``_stacked_pipeline_aux``,
``delta_rank_adjust``) and ``repro.kernels.plex_segment_lookup``
(``stacked_radix_window_base`` / ``stacked_cht_window_base``, ``_interp``,
``probe_lower_bound``), fused on the TPU into the Pallas kernel
``repro.kernels.stacked_pallas.stacked_pallas_lookup``:

1. route: shard id = #{shard minima <= q} - 1, clipped to ``[0, S-1]``;
2. window over spline points: radix prefix ``(q - min) >> shift`` (0 below
   min, saturated at ``p_max``) bounded by two table entries, or a CHT
   descent over ``levels`` cells (top bit = child);
3. spline predecessor in that window, by count or by fixed-trip bisect;
4. float32 interpolation on the exact 64-bit key difference, bit for bit as
   the reference rounds it; base = ``clip(floor(pred) - eps_eff, 0,
   n_data_max - window)``;
5. eps-window data probe: first index in ``[base, base + window]`` whose key
   is >= q, by count or, as the bisect form, by the summary probe
   (``bounded_search.summary_lower_bound`` over the shard's row of the
   planes' ``KeySummary``);
6. clamp to the shard's real key count and add its global row offset;
7. with a live delta buffer (``cap > 0``): add ``cum0[# delta keys < q]``.

One departure from the reference: its radix prefix keeps the low 32 bits of
the shifted difference, which sends a key far past the last one on a narrow
radix shard to an arbitrary bucket and a wrong rank (ROADMAP queue 3, R5);
here the whole shifted difference saturates at the last bucket, as in K2.
Where ``(q - min) >> shift < 2^31`` both give the same prefix.

``stacked_lookup_plain`` writes these steps in torch int64/float32 ops and
runs on any device; ``stacked_lookup`` dispatches on the query tensor's
device: the plain version for CPU tensors, the CUDA kernel
(``csrc/stacked_lookup.cu``) for CUDA tensors — never a fallback between
them. ``launches`` counts kernel launches.

The launches of one dispatch are independent (they read the same read-only
planes and each writes its own output), so every launch but a dispatch's
first asks for ``overlap``: Hopper's programmatic dependent launch, which
starts its blocks while the previous launch's last queries are in flight.
A dispatch's first launch never overlaps, so K1 never starts before a
PyTorch kernel whose output it reads has finished.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.plex import PLEX
from ..device import resolve_device
from ._build import check_launch, check_params_size, device_ptr, load_library
from .bounded_search import DEFAULT_PROBE, PROBE_MODES, probe_lower_bound, \
    summary_lower_bound
from .keys import diff, extract_bits, le, lt, take as _take, to_biased
from .planes import DeltaPlanes, StackedPlanes, build_stacked_planes
from .segment_lookup import cht_geometry, interp, radix_geometry, \
    radix_window

DEFAULT_BLOCK = 512

# kernel launches of ``stacked_lookup`` on CUDA tensors (plain integer; set
# to 0 before a run and read after it to see which path ran)
launches = 0


def _route(sp: StackedPlanes, q: torch.Tensor) -> torch.Tensor:
    """Shard id per query: predecessor count over the shard-minima plane."""
    if sp.n_shards == 1:
        return torch.zeros_like(q)
    cnt = le(sp.shard_min[None, :], q[:, None]).sum(dim=1)
    return torch.clamp(cnt - 1, 0, sp.n_shards - 1)


def _search_geometry(sp: StackedPlanes) -> tuple[int, int]:
    """Width of the spline window the count search covers, and the trips of
    the bisect over it."""
    if sp.kind == "radix":
        return radix_geometry(sp.static["max_win"])
    return cht_geometry(sp.static["delta_max"])


def _spline_window(sp: StackedPlanes, q: torch.Tensor, sid: torch.Tensor,
                   ns: torch.Tensor):
    """Inclusive window ``[lo, hi]`` of local spline indices holding the
    query's predecessor."""
    la = sp.layer_arrays
    s = sp.static
    if sp.kind == "radix":
        lmin = _take(la["lmin"], sid)
        below = lt(q, lmin)
        d = torch.where(below, torch.zeros_like(q), diff(q, lmin))
        return radix_window(la["table"], d, _take(la["shift"], sid).long(),
                            _take(la["p_max"], sid).long(),
                            off=_take(la["table_off"], sid).long())
    r = s["r"]
    coff = _take(la["cells_off"], sid).long()
    node = torch.zeros_like(q)
    out = torch.zeros_like(q)
    done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    for level in range(s["levels"]):
        cell = _take(la["cells"], coff + node * (1 << r)
                     + extract_bits(q, level * r, r)).long()
        is_child = cell < 0                       # top bit of the u32 cell
        val = cell & 0x7FFFFFFF
        out = torch.where(~done & ~is_child, val, out)
        node = torch.where(~done & is_child, val, node)
        done = done | ~is_child
    hi = torch.minimum(out + _take(la["delta"], sid).long(), ns - 1)
    return out, hi


def _predecessor(sp, q, row, ns, lo, hi):
    """Largest local i in [lo, hi] with sk[i] <= q (lo when none is)."""
    width, trips = _search_geometry(sp)
    if sp.static["mode"] == "count":
        offs = torch.arange(width, device=q.device)
        idx = row[:, None] + torch.minimum(lo[:, None] + offs,
                                           (ns - 1)[:, None])
        valid = offs[None, :] <= (hi - lo)[:, None]
        cnt = (le(_take(sp.sk, idx), q[:, None]) & valid).sum(dim=1)
        return lo + torch.clamp(cnt - 1, min=0)
    for _ in range(trips):
        mid = (lo + hi + 1) >> 1
        go = le(_take(sp.sk, row + torch.minimum(mid, ns - 1)), q)
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    return lo


def stacked_lookup_plain(sp: StackedPlanes, probe: str, q: torch.Tensor,
                         delta: DeltaPlanes | None = None):
    """The whole pipeline in plain torch ops on ``q``'s device.

    Returns ``(out, sid, base)``: global (merged, when ``delta`` is given)
    int32 first-occurrence indices, the routed shard id and the local
    eps-window base per query (both int32)."""
    sid = _route(sp, q)
    ns = _take(sp.n_spline, sid).long()
    row = sid * sp.n_spline_max
    lo, hi = _spline_window(sp, q, sid, ns)
    seg = _predecessor(sp, q, row, ns, lo, hi)
    # min(max(.)) order, as jnp.clip: with one spline point this gives -1
    seg = torch.minimum(torch.clamp(seg, min=0), ns - 2)
    pred = interp(sp.sk, sp.spos, q, row + seg)
    base = torch.floor(pred).long() - sp.eps_eff
    base = torch.clamp(base, 0, sp.n_data_max - sp.window)
    if probe == "count":
        drow = sid * sp.n_data_max
        got = probe_lower_bound(sp.dk, q, drow + base, window=sp.window,
                                mode="count") - drow
    else:
        got = summary_lower_bound(sp.dk, sp.summary, q, base,
                                  window=sp.window, row=sid)
    out = torch.minimum(got, _take(sp.n_real, sid).long()) \
        + _take(sp.row_off, sid).long()
    if delta is not None:
        cnt = probe_lower_bound(delta.keys, q, torch.zeros_like(q),
                                window=delta.cap, mode="bisect")
        out = out + _take(delta.cum0, cnt).long()
    return out.int(), sid.int(), base.int()


# ----------------------------------------------------------------- kernel --

class _Params(ctypes.Structure):
    """Mirror of ``PlexParams`` in ``csrc/stacked_lookup.cu`` (same field
    order and types)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "sk", "spos", "dk", "n_spline", "n_real", "row_off",
        "shard_min", "table", "table_off", "shift", "p_max", "lmin",
        "cells", "cells_off", "delta", "dkeys", "dcum", "s1", "s2", "out",
        "sid_out", "base_out")] + [(name, ctypes.c_int64) for name in (
        "n_q", "n_spline_max", "n_data_max", "n1", "n2")] + [
        (name, ctypes.c_int32) for name in (
            "n_shards", "eps_eff", "window", "search_width", "search_trips",
            "r", "levels", "cap", "delta_trips")]


_EXPECT = {"sk": torch.int64, "spos": torch.float32, "dk": torch.int64,
           "n_spline": torch.int32, "n_real": torch.int32,
           "row_off": torch.int32, "shard_min": torch.int64,
           "table": torch.int32, "table_off": torch.int32,
           "shift": torch.int32, "p_max": torch.int32, "lmin": torch.int64,
           "cells": torch.int32, "cells_off": torch.int32,
           "delta": torch.int32, "dkeys": torch.int64,
           "dcum": torch.int32, "s1": torch.int64, "s2": torch.int64}


def _ptr(name: str, t: torch.Tensor, dev: torch.device) -> int:
    return device_ptr(name, t, _EXPECT[name], dev)


def _launch(sp: StackedPlanes, probe: str, q: torch.Tensor,
            delta: DeltaPlanes | None, aux: bool, overlap: bool):
    """One kernel launch over ``q`` on the current stream (no sync, no
    allocation inside the kernel); with ``overlap``, a programmatic
    dependent launch on its predecessor."""
    global launches
    lib = load_library("stacked_lookup")
    check_params_size(lib, "plex_params_size", _Params)
    dev = q.device
    if q.dtype != torch.int64 or q.dim() != 1 or not q.is_contiguous():
        raise ValueError("queries must be a contiguous 1-D int64 tensor")
    if q.numel() >= (1 << 31):
        raise ValueError("a launch takes fewer than 2^31 queries")
    if probe not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {probe!r}")
    n = q.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    sid = torch.empty(n, dtype=torch.int32, device=dev) if aux else None
    base = torch.empty(n, dtype=torch.int32, device=dev) if aux else None
    s = sp.static
    p = _Params()
    p.q = q.data_ptr()
    for name in ("sk", "spos", "dk", "n_spline", "n_real", "row_off",
                 "shard_min"):
        setattr(p, name, _ptr(name, getattr(sp, name), dev))
    for name, t in sp.layer_arrays.items():
        setattr(p, name, _ptr(name, t, dev))
    p.s1 = _ptr("s1", sp.summary.l1, dev)
    p.s2 = _ptr("s2", sp.summary.l2, dev)
    p.n1 = sp.summary.n1
    p.n2 = sp.summary.n2
    p.search_width, p.search_trips = _search_geometry(sp)
    if sp.kind == "cht":
        p.r = s["r"]
        p.levels = s["levels"]
    if delta is not None:
        if delta.keys.numel() != delta.cap or delta.cum0.numel() != \
                delta.cap + 1:
            raise ValueError("delta planes do not match their capacity")
        p.dkeys = _ptr("dkeys", delta.keys, dev)
        p.dcum = _ptr("dcum", delta.cum0, dev)
        p.cap = delta.cap
        p.delta_trips = int(delta.cap).bit_length()
    p.out = out.data_ptr()
    p.sid_out = sid.data_ptr() if aux else None
    p.base_out = base.data_ptr() if aux else None
    p.n_q = n
    p.n_spline_max = sp.n_spline_max
    p.n_data_max = sp.n_data_max
    p.n_shards = sp.n_shards
    p.eps_eff = sp.eps_eff
    p.window = sp.window
    # 0: the count sweep; 1, 2: the summary probe over that many levels
    form = sp.summary.levels if probe == "bisect" else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.plex_stacked_lookup(
        ctypes.addressof(p), int(sp.kind == "cht"), int(s["mode"] == "bisect"),
        form, int(delta is not None), int(overlap), stream)
    check_launch(lib, "plex_error_string", err, "stacked_lookup")
    launches += 1
    return out, sid, base


def stacked_lookup(sp: StackedPlanes, probe: str, q: torch.Tensor,
                   delta: DeltaPlanes | None = None, *, aux: bool = False,
                   overlap: bool = False):
    """Global (merged, with ``delta``) int32 indices for biased int64
    queries ``q`` on the planes' device. With ``aux`` also the routed shard
    ids and local window bases (``None`` otherwise). ``overlap``: the
    previous work on the stream is a launch of the same dispatch, which
    this one may overlap (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device != sp.device:
        raise ValueError(f"queries on {q.device}, planes on {sp.device}")
    if q.device.type == "cpu":
        out, sid, base = stacked_lookup_plain(sp, probe, q, delta)
        return (out, sid, base) if aux else (out, None, None)
    if q.device.type == "cuda":
        return _launch(sp, probe, q, delta, aux, overlap)
    raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------- serving impl --

class LaneResult(NamedTuple):
    """One micro-batch dispatch: the device tensor of global int32 indices
    (asynchronous on the card: reading it synchronises)."""
    out: torch.Tensor


@dataclasses.dataclass
class StackedTorchPlex:
    """Single-launch multi-shard lookup over ``StackedPlanes``.

    ``lookup_planes`` runs one micro-batch in one kernel launch; passing a
    ``DeltaPlanes`` buffer folds the delta into the same launch (a merged
    lookup, equal to searchsorted over the logical key array)."""

    planes: StackedPlanes
    block: int
    probe: str

    @classmethod
    def from_plexes(cls, plexes: Sequence[PLEX], row_off: np.ndarray, *,
                    device=None, block: int = DEFAULT_BLOCK,
                    probe: str | None = None, host_planes=None,
                    summary_keys: int | None = None
                    ) -> "StackedTorchPlex | None":
        """Build the fused stacked path on ``device``, or ``None`` when the
        shards' static parameters cannot be unified. ``summary_keys``: see
        ``build_stacked_planes``."""
        device = resolve_device(device)
        probe = probe or DEFAULT_PROBE
        if probe not in PROBE_MODES:
            raise ValueError(f"unknown probe mode {probe!r}")
        if block % 128 != 0:
            raise ValueError("block must be a multiple of 128 lanes")
        sp = build_stacked_planes(plexes, row_off, device,
                                  host_planes=host_planes,
                                  summary_keys=summary_keys)
        if sp is None:
            return None
        return cls(planes=sp, block=int(block), probe=probe)

    @property
    def n_real_total(self) -> int:
        return self.planes.n_real_total

    def lookup_planes(self, q: torch.Tensor, n_valid: int | None = None,
                      delta: DeltaPlanes | None = None, *,
                      overlap: bool = False) -> LaneResult:
        """One micro-batch of biased int64 queries on the planes' device ->
        ``LaneResult``; asynchronous on the card. ``n_valid`` keeps the
        reference's signature: the kernel takes any length and computes
        every lane, so nothing is padded and this slice only checks it.
        ``overlap``: see ``stacked_lookup``."""
        if n_valid is not None and not 0 <= n_valid <= q.numel():
            raise ValueError(f"n_valid={n_valid} outside [0, {q.numel()}]")
        dp = delta if delta is not None and delta.n_entries else None
        out, _, _ = stacked_lookup(self.planes, self.probe, q, dp,
                                   overlap=overlap)
        return LaneResult(out)

    def dispatch(self, qd: torch.Tensor, delta: DeltaPlanes | None = None,
                 *, chained: bool = False) -> list[torch.Tensor]:
        """One launch per ``block``-sized micro-batch of the device queries
        ``qd`` (the last one may be shorter); asynchronous. Every launch
        but the first overlaps the one before it; with ``chained`` (the
        previous work on the stream is a launch of the same dispatch) the
        first does too."""
        b = self.block
        return [self.lookup_planes(qd[i:i + b], delta=delta,
                                   overlap=chained or i > 0).out
                for i in range(0, qd.numel(), b)]

    def lookup(self, q: np.ndarray, delta: DeltaPlanes | None = None
               ) -> np.ndarray:
        """Batched global lookup of uint64 keys: one upload, one launch per
        ``block`` micro-batch, one sync at the end."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=np.int64)
        qd = torch.from_numpy(to_biased(q)).to(self.planes.device)
        return torch.cat(self.dispatch(qd, delta)).cpu().numpy().astype(
            np.int64)
