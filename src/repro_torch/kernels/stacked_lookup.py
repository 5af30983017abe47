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

Two options wrap the pipeline, the reference's jnp glue around its Pallas
kernel (``jnp_lookup._stacked_cached`` and ``_stacked_counted``), here in the
same launch:

* the hot-key cache (``cache``): a direct-mapped table of *snapshot* ranks
  (the clamped global index before the delta fold), one slot per
  ``cache_slot`` of the key, each a packed (biased key, rank) row of one
  int64 pair, rank -1 when empty. A lane whose slot holds its key takes the
  cached rank and skips steps 1-6; a lane that missed writes its key and
  snapshot rank through to its slot (the kernel skips a hit's store, whose
  slot already holds them; the plain version writes every lane, as the
  reference does); the delta folds in after the cache on every lane, so
  entries stay valid across inserts and deletes and die with their
  snapshot. The launch adds its hits to ``hits``;
* the counter plane (``counters``, int64 ``[n_shards + N_PROBE_BUCKETS]``):
  the routed count per shard, then the log2 histogram (``probe_bucket``) of
  each query's probe travel, its answer minus its window base. The counted
  dispatch bypasses the cache, as the reference's does, so one launch never
  takes both.

``stacked_lookup_plain`` writes these steps in torch int64/float32 ops and
runs on any device; ``stacked_lookup`` dispatches on the query tensor's
device: the plain version for CPU tensors, the CUDA kernel
(``csrc/stacked_lookup.cu``) for CUDA tensors — never a fallback between
them. Only a caller that asks for it by ``plain=True`` (the registry's
``torch`` backend, ``kernels.backends``) runs the plain version on CUDA
tensors. ``launches`` counts kernel launches, ``plain_calls`` the calls
that asked for the plain version. The plain version gathers the
whole batch's slots first and then writes them, as the reference does, so
its hit counts equal the reference's wherever no two distinct keys of a
launch share a slot; in the kernel, lanes of one launch see one another's
write-through, so a launch's hit count may differ from the plain version's
(its results never do).

The launches of one dispatch are independent (they read the same read-only
planes and each writes its own output), so every launch but a dispatch's
first asks for ``overlap``: Hopper's programmatic dependent launch, which
starts its blocks while the previous launch's last queries are in flight.
A dispatch's first launch never overlaps, so K1 never starts before a
PyTorch kernel whose output it reads has finished. With the cache on, a
launch reads the slots its predecessor writes, so each cached launch waits
for it before probing (``griddepcontrol.wait``) and overlaps only its
prologue.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.plex import PLEX
from ..device import resolve_device
from ..obs.metrics import METRICS
from ._build import check_launch, check_params_size, device_ptr, load_library
from .bounded_search import DEFAULT_PROBE, PROBE_MODES, probe_lower_bound, \
    summary_lower_bound
from .keys import diff, extract_bits, le, lt, split_words, \
    take as _take, to_biased
from .planes import DeltaPlanes, StackedPlanes, build_stacked_planes
from .segment_lookup import cht_geometry, interp, radix_geometry, \
    radix_window

DEFAULT_BLOCK = 512
# probe-travel histogram resolution of the counter plane: bucket 0 is an
# exact window-base landing, bucket k covers travel in [2^(k-1), 2^k), the
# last bucket overflows
N_PROBE_BUCKETS = 16

# kernel launches of ``stacked_lookup`` on CUDA tensors (plain integer; set
# to 0 before a run and read after it to see which path ran)
launches = 0
# calls of ``stacked_lookup`` that asked for the plain version by ``plain``
plain_calls = 0

_LOW32 = 0xFFFFFFFF
# bucket k >= 1 starts at 2^(k-1)
_BUCKET_EDGES = [1 << k for k in range(N_PROBE_BUCKETS - 1)]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for ``0 <= x < 2^32`` in int64 without
    overflow: the product is split at bit 16 of ``x``."""
    return ((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c & _LOW32


def cache_slot(q: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Direct-mapped slot per biased query key: the reference's
    ``_cache_slot``, a 32-bit multiplicative mix of the unbiased key's two
    words masked to the power-of-two capacity (int64)."""
    hi, lo = split_words(q ^ torch.iinfo(torch.int64).min)
    h = _mul32(lo, 0x9E3779B1) ^ _mul32(hi, 0x85EBCA77)
    h = h ^ (h >> 16)
    return h & (n_slots - 1)


def probe_bucket(travel: torch.Tensor) -> torch.Tensor:
    """The reference's ``_probe_bucket``: 0 for a travel <= 0, else
    ``bit_length(travel)`` clipped to the last bucket. The reference takes
    ``floor(log2(travel)) + 1`` in float32, with log2 as ``log(x) /
    log(2)``, which rounds 2^13 just below 13; that travel lands in bucket
    13, not 14 (ROADMAP queue 3, R7), and so it does here."""
    edges = torch.tensor(_BUCKET_EDGES, dtype=torch.int64,
                         device=travel.device)
    b = torch.bucketize(travel.long(), edges, right=True)
    return torch.where(travel == 8192, 13, b)


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


def _snapshot_plain(sp: StackedPlanes, probe: str, q: torch.Tensor):
    """Steps 1-6 for each query: ``(rank, sid, base, got)``, its clamped
    global snapshot rank, routed shard, local window base and local probe
    answer (int64)."""
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
    rank = torch.minimum(got, _take(sp.n_real, sid).long()) \
        + _take(sp.row_off, sid).long()
    return rank, sid, base, got


def _cached_plain(sp, probe, q, cache, hits):
    """Snapshot ranks through the hot-key cache, as ``_stacked_cached``
    resolves them: the whole batch's slots are gathered first, the misses
    run the pipeline, then each slot is written once (by the last lane that
    maps to it, one packed row: a slot's key and rank are never torn)."""
    slots = cache.view(-1, 2)
    slot = cache_slot(q, slots.shape[0])
    entry = slots[slot]
    hit = (entry[:, 1] >= 0) & (entry[:, 0] == q)
    rank = entry[:, 1].clone()
    miss = ~hit
    if bool(miss.any()):
        rank[miss] = _snapshot_plain(sp, probe, q[miss])[0]
    hits += hit.sum().to(hits.dtype)
    uniq, inv = torch.unique(slot, return_inverse=True)
    lane = torch.arange(q.numel(), device=q.device)
    last = torch.full((uniq.numel(),), -1, dtype=torch.int64,
                      device=q.device).scatter_reduce_(0, inv, lane, "amax")
    slots[uniq] = torch.stack([q[last], rank[last]], dim=1)
    return rank


def stacked_lookup_plain(sp: StackedPlanes, probe: str, q: torch.Tensor,
                         delta: DeltaPlanes | None = None, *,
                         cache: torch.Tensor | None = None,
                         hits: torch.Tensor | None = None,
                         counters: torch.Tensor | None = None):
    """The whole pipeline in plain torch ops on ``q``'s device.

    Returns ``(out, sid, base)``: global (merged, when ``delta`` is given)
    int32 first-occurrence indices, the routed shard id and the local
    eps-window base per query (both int32; ``None`` with the cache, whose
    hits compute neither). ``cache``, ``hits`` and ``counters`` are updated
    in place (see the module docstring)."""
    if cache is not None:
        rank = _cached_plain(sp, probe, q, cache, hits)
        sid = base = None
    else:
        rank, sid, base, got = _snapshot_plain(sp, probe, q)
        if counters is not None:
            counters[:sp.n_shards] += torch.bincount(
                sid, minlength=sp.n_shards)
            counters[sp.n_shards:] += torch.bincount(
                probe_bucket(got - base), minlength=N_PROBE_BUCKETS)
        sid, base = sid.int(), base.int()
    out = rank
    if delta is not None:
        cnt = probe_lower_bound(delta.keys, q, torch.zeros_like(q),
                                window=delta.cap, mode="bisect")
        out = out + _take(delta.cum0, cnt).long()
    return out.int(), sid, base


# ----------------------------------------------------------------- kernel --

class _Params(ctypes.Structure):
    """Mirror of ``PlexParams`` in ``csrc/stacked_lookup.cu`` (same field
    order and types)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "sk", "spos", "dk", "n_spline", "n_real", "row_off",
        "shard_min", "table", "table_off", "shift", "p_max", "lmin",
        "cells", "cells_off", "delta", "dkeys", "dcum", "s1", "s2", "out",
        "sid_out", "base_out", "cache", "hits", "counters")] + [
        (name, ctypes.c_int64) for name in (
            "n_q", "n_spline_max", "n_data_max", "n1", "n2")] + [
        (name, ctypes.c_int32) for name in (
            "n_shards", "eps_eff", "window", "search_width", "search_trips",
            "r", "levels", "cap", "delta_trips", "cache_mask")]


_EXPECT = {"sk": torch.int64, "spos": torch.float32, "dk": torch.int64,
           "n_spline": torch.int32, "n_real": torch.int32,
           "row_off": torch.int32, "shard_min": torch.int64,
           "table": torch.int32, "table_off": torch.int32,
           "shift": torch.int32, "p_max": torch.int32, "lmin": torch.int64,
           "cells": torch.int32, "cells_off": torch.int32,
           "delta": torch.int32, "dkeys": torch.int64,
           "dcum": torch.int32, "s1": torch.int64, "s2": torch.int64,
           "cache": torch.int64, "hits": torch.int32,
           "counters": torch.int64}


def _ptr(name: str, t: torch.Tensor, dev: torch.device) -> int:
    return device_ptr(name, t, _EXPECT[name], dev)


def _launch(sp: StackedPlanes, probe: str, q: torch.Tensor,
            delta: DeltaPlanes | None, aux: bool, overlap: bool,
            cache, hits, counters):
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
    if cache is not None:
        p.cache = _ptr("cache", cache, dev)
        p.hits = _ptr("hits", hits, dev)
        p.cache_mask = cache.numel() // 2 - 1
    if counters is not None:
        p.counters = _ptr("counters", counters, dev)
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


def _check_options(sp: StackedPlanes, aux: bool, cache, hits,
                   counters) -> None:
    """Refuse what neither version takes: the cache beside the counters or
    ``aux`` (hits compute no shard id or base), or planes of the wrong
    shape."""
    if cache is not None:
        if counters is not None or aux:
            raise ValueError("the cached lookup takes neither counters nor "
                             "aux outputs")
        n_slots = cache.numel() // 2
        if cache.dim() != 1 or cache.numel() != 2 * n_slots or \
                n_slots < 1 or n_slots & (n_slots - 1) or n_slots > 1 << 31:
            raise ValueError("cache must be a 1-D tensor of 2 * slots "
                             "entries, slots a power of two up to 2^31")
        if hits is None or hits.numel() != 1:
            raise ValueError("a cached lookup needs a one-element hits "
                             "tensor")
    if counters is not None and \
            counters.shape != (sp.n_shards + N_PROBE_BUCKETS,):
        raise ValueError(f"counters must have n_shards + {N_PROBE_BUCKETS}"
                         f" = {sp.n_shards + N_PROBE_BUCKETS} entries")


def stacked_lookup(sp: StackedPlanes, probe: str, q: torch.Tensor,
                   delta: DeltaPlanes | None = None, *, aux: bool = False,
                   overlap: bool = False, cache: torch.Tensor | None = None,
                   hits: torch.Tensor | None = None,
                   counters: torch.Tensor | None = None,
                   plain: bool = False):
    """Global (merged, with ``delta``) int32 indices for biased int64
    queries ``q`` on the planes' device. With ``aux`` also the routed shard
    ids and local window bases (``None`` otherwise). ``overlap``: the
    previous work on the stream is a launch of the same dispatch, which
    this one may overlap (see the module docstring). ``cache`` (int64
    ``[2 * slots]``) with ``hits`` (int32, one element), or ``counters``
    (int64 ``[n_shards + N_PROBE_BUCKETS]``): see the module docstring;
    all three are updated in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise, unless ``plain`` asks for the plain version on any device."""
    global plain_calls
    if q.device != sp.device:
        raise ValueError(f"queries on {q.device}, planes on {sp.device}")
    _check_options(sp, aux, cache, hits, counters)
    if plain:
        plain_calls += 1
    if plain or q.device.type == "cpu":
        out, sid, base = stacked_lookup_plain(sp, probe, q, delta,
                                              cache=cache, hits=hits,
                                              counters=counters)
        return (out, sid, base) if aux else (out, None, None)
    if q.device.type == "cuda":
        return _launch(sp, probe, q, delta, aux, overlap, cache, hits,
                       counters)
    raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------- serving impl --

class LaneResult(NamedTuple):
    """One micro-batch dispatch: the device tensor of global int32 indices
    (asynchronous on the card: reading it synchronises) and, with the
    cache, the launch's hit count (a one-element device tensor). The port
    launches only valid lanes, so every lane of ``out`` counts."""
    out: torch.Tensor
    hits: torch.Tensor | None = None

    @property
    def full_hit(self) -> bool | None:
        """Whether every lane hit (``None`` with the cache off); reading it
        synchronises."""
        if self.hits is None:
            return None
        return int(self.hits) == self.out.numel()


@dataclasses.dataclass
class StackedTorchPlex:
    """Single-launch multi-shard lookup over ``StackedPlanes``.

    ``lookup_planes`` runs one micro-batch in one kernel launch; passing a
    ``DeltaPlanes`` buffer folds the delta into the same launch (a merged
    lookup, equal to searchsorted over the logical key array). With
    ``cache_slots`` the impl owns a hot-key cache of that many slots on the
    planes' device; while ``METRICS`` is armed for the counted dispatch it
    owns a counter plane, read and reset by ``take_counters``. ``plain``:
    every launch runs the plain version, on the card too (the ``torch``
    backend)."""

    planes: StackedPlanes
    block: int
    probe: str
    cache_slots: int = 0
    plain: bool = False
    _cache: torch.Tensor | None = dataclasses.field(default=None,
                                                    repr=False)
    _counters: torch.Tensor | None = dataclasses.field(default=None,
                                                       repr=False)

    @classmethod
    def from_plexes(cls, plexes: Sequence[PLEX], row_off: np.ndarray, *,
                    device=None, block: int = DEFAULT_BLOCK,
                    probe: str | None = None, cache_slots: int = 0,
                    host_planes=None, summary_keys: int | None = None,
                    plain: bool = False, planes: StackedPlanes | None = None
                    ) -> "StackedTorchPlex | None":
        """Build the fused stacked path on ``device``, or ``None`` when the
        shards' static parameters cannot be unified. ``cache_slots``: a
        power of two, or 0 for no cache. ``host_planes``: the shards'
        ``_HostPlanes`` when the caller has them (a loaded snapshot).
        ``summary_keys``: see ``build_stacked_planes``. ``plain``: see the
        class docstring. ``planes``: these shards' device planes, already
        built (another impl's): adopted as they are, nothing is rebuilt."""
        device = resolve_device(device)
        probe = probe or DEFAULT_PROBE
        if probe not in PROBE_MODES:
            raise ValueError(f"unknown probe mode {probe!r}")
        if block % 128 != 0:
            raise ValueError("block must be a multiple of 128 lanes")
        check_cache_slots(cache_slots)
        sp = planes if planes is not None else build_stacked_planes(
            plexes, row_off, device, host_planes=host_planes,
            summary_keys=summary_keys)
        if sp is None:
            return None
        st = cls(planes=sp, block=int(block), probe=probe,
                 cache_slots=int(cache_slots), plain=bool(plain))
        st.reset_cache()
        return st

    @property
    def n_real_total(self) -> int:
        return self.planes.n_real_total

    def reset_cache(self) -> None:
        """Empty the hot-key cache (no-op without one). Updates never need
        it: entries hold delta-independent snapshot ranks."""
        if self.cache_slots:
            self._cache = torch.full((2 * self.cache_slots,), -1,
                                     dtype=torch.int64,
                                     device=self.planes.device)

    def take_counters(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Read the counter plane back to the host and drop it (the next
        counted dispatch starts a fresh one): ``(shard_counts,
        probe_hist)`` as int64 arrays, or ``None`` when no counted dispatch
        has run since the last take, so uncounted serving reads nothing
        back. Best-effort under concurrent dispatches (one racing the swap
        may drop its counts); a single-threaded stream folds exactly."""
        c = self._counters
        if c is None:
            return None
        self._counters = None
        host = c.cpu().numpy()
        n = self.planes.n_shards
        return host[:n], host[n:]

    def _fresh_counters(self) -> torch.Tensor:
        return torch.zeros(self.planes.n_shards + N_PROBE_BUCKETS,
                           dtype=torch.int64, device=self.planes.device)

    def lookup_planes(self, q: torch.Tensor, n_valid: int | None = None,
                      delta: DeltaPlanes | None = None, *,
                      overlap: bool = False, counted: bool | None = None,
                      hits: torch.Tensor | None = None) -> LaneResult:
        """One micro-batch of biased int64 queries on the planes' device ->
        ``LaneResult``; asynchronous on the card. ``n_valid`` keeps the
        reference's signature: the kernel takes any length and computes
        every lane, so nothing is padded and this slice only checks it.
        ``overlap``: see ``stacked_lookup``. ``counted``: run the counted
        dispatch (default: while ``METRICS`` is armed for it), which
        bypasses the cache, as the reference's does, so the live hotness
        sees every query through the pipeline. ``hits``: the one-element
        tensor a cached launch adds its hits to (a fresh one by default)."""
        n = q.numel()
        if n_valid is not None and not 0 <= n_valid <= n:
            raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
        dp = delta if delta is not None and delta.n_entries else None
        if counted is None:
            counted = METRICS.enabled and METRICS.counted_dispatch
        if counted:
            if self._counters is None:
                self._counters = self._fresh_counters()
            out, _, _ = stacked_lookup(self.planes, self.probe, q, dp,
                                       overlap=overlap,
                                       counters=self._counters,
                                       plain=self.plain)
            return LaneResult(out)
        if self._cache is not None:
            if hits is None:
                hits = torch.zeros(1, dtype=torch.int32, device=q.device)
            out, _, _ = stacked_lookup(self.planes, self.probe, q, dp,
                                       overlap=overlap, cache=self._cache,
                                       hits=hits, plain=self.plain)
            return LaneResult(out, hits)
        out, _, _ = stacked_lookup(self.planes, self.probe, q, dp,
                                   overlap=overlap, plain=self.plain)
        return LaneResult(out)

    def dispatch(self, qd: torch.Tensor, delta: DeltaPlanes | None = None,
                 *, chained: bool = False, counted: bool | None = None
                 ) -> list[LaneResult]:
        """One launch per ``block``-sized micro-batch of the device queries
        ``qd`` (the last one may be shorter); asynchronous. Every launch
        but the first overlaps the one before it; with ``chained`` (the
        previous work on the stream is a launch of the same dispatch) the
        first does too.
        Cached launches add their hits to one plane of the dispatch, zeroed
        before its first launch."""
        b = self.block
        starts = range(0, qd.numel(), b)
        if counted is None:
            counted = METRICS.enabled and METRICS.counted_dispatch
        cached = self._cache is not None and not counted
        hits = (torch.zeros(len(starts), dtype=torch.int32, device=qd.device)
                if cached else None)
        return [self.lookup_planes(
            qd[i:i + b], delta=delta, counted=counted,
            overlap=chained or i > 0,
            hits=None if hits is None else hits[j:j + 1])
            for j, i in enumerate(starts)]

    def lookup(self, q: np.ndarray, delta: DeltaPlanes | None = None
               ) -> np.ndarray:
        """Batched global lookup of uint64 keys: one upload, one launch per
        ``block`` micro-batch, one sync at the end."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=np.int64)
        qd = torch.from_numpy(to_biased(q)).to(self.planes.device)
        return torch.cat([r.out for r in self.dispatch(qd, delta)]) \
            .cpu().numpy().astype(np.int64)


def check_cache_slots(cache_slots: int) -> None:
    """Refuse a cache size that is not 0 or a power of two (the slot hash
    masks to the capacity)."""
    if cache_slots < 0 or cache_slots & (cache_slots - 1):
        raise ValueError("cache_slots must be a power of two")
