"""K2 and K3: the single-index segment lookup, plain PyTorch version and
CUDA kernel wrapper (the port of the single-index half of
``repro.kernels.plex_segment_lookup``), alone or fused with K4.

Per query, the base of its eps window over the data plane:

1. window over spline points: radix prefix ``(q - min) >> shift`` (0 below
   min, clipped to ``2^r - 1``) bounded by ``table[p] - 1`` and
   ``table[p + 1] - 1`` floored at 0 (K2), or a CHT
   descent over ``levels`` cells, top bit = child, then
   ``[out, min(out + delta, n_spline - 1)]`` (K3);
2. spline predecessor in that window, in one of the ``SEARCH_FORMS``:
   ``"count"`` and ``"bisect"`` (fixed trips) as the reference writes them,
   or ``"adaptive"``: bisect rounds until the window closes (in the kernel
   the keys it probed at the predecessor and after it also serve the
   interpolation). All three give the same predecessor;
3. float32 interpolation on the exact 64-bit key difference, rounded as the
   reference rounds it;
4. base = ``clip(floor(pred) - eps_eff, 0, n_data - window)``.

One departure from the reference: its radix prefix keeps the low 32 bits
of the shifted difference, cast to int32, which sends a key far past the last
one to an arbitrary bucket and a wrong rank (ROADMAP queue 3, R5); here the
whole shifted difference is clipped, so such a key lands in the last bucket.
Where ``(q - min) >> shift < 2^31``, as for every key up to the last, both
give the same prefix, so window bases and ranks are the reference's.

``radix_window_base`` / ``cht_window_base`` are the plain versions (torch
int64/float32 ops on any device). ``radix_segment_lookup`` /
``cht_segment_lookup`` dispatch on the query tensor's device: the plain
version for CPU tensors, the kernel (``csrc/segment_lookup.cu``) for CUDA
tensors, never a fallback between them. On the card ``window_base`` runs
``CARD_FORM``, on the CPU the planes' ``mode`` (the reference's rule);
an explicit ``mode`` runs that form on either. The
reference hands its CHT kernel an int32 ``[levels, B]`` bins plane; here
the bins come from the key (``keys.extract_bits``, in the kernel too), so
none is materialised. ``launches`` counts kernel launches.

``window_probe`` is the same kernel with K4's summary probe run on the base
in registers (one launch for K2/K3 + K4, counted in ``fused_launches``);
``window_probe_plain`` is ``bounded_search_plain`` applied to
``window_base_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_params_size, device_ptr, load_library
from .bounded_search import bounded_search_plain
from .keys import diff, diff_to_f32, extract_bits, le, lt, shr_sat, take
from .planes import PlexPlanes

SEARCH_FORMS = ("count", "bisect", "adaptive")  # kCount, kBisect, kAdaptive
# the form the card runs by default: the adaptive one was the fastest of the
# three at every window width measured, 3 to 354 points (PERF.md)
CARD_FORM = "adaptive"

# kernel launches of the two wrappers on CUDA tensors, and of the fused
# K2/K3 + K4 form (plain integers; set to 0 before a run and read after it
# to see which path ran)
launches = 0
fused_launches = 0


def interp(sk: torch.Tensor, spos: torch.Tensor, q: torch.Tensor,
           g: torch.Tensor) -> torch.Tensor:
    """float32 spline interpolation at segment index ``g`` (already
    clipped), rounding exactly as the reference's ``_interp``."""
    x0 = take(sk, g)
    x1 = take(sk, g + 1)
    y0 = take(spos, g)
    y1 = take(spos, g + 1)
    dx = torch.clamp(diff_to_f32(diff(x1, x0)), min=1.0)
    # a query below the segment start snaps to t = 0
    dq = torch.where(lt(q, x0), torch.zeros_like(dx),
                     diff_to_f32(diff(q, x0)))
    t = torch.clamp(dq / dx, 0.0, 1.0)
    return y0 + t * (y1 - y0)


def _predecessor(q, sk, lo, hi, *, width: int, trips: int, mode: str):
    """Largest i in [lo, hi] with sk[i] <= q (lo when none is): a masked
    count over ``width`` keys, ``trips`` fixed bisect rounds, or bisect
    rounds while the window holds more than one point (the adaptive form;
    ``hi`` clipped to the last key first, which leaves the base as the
    others give it: the interpolation clips every predecessor to
    ``n_spline - 2``)."""
    last = sk.numel() - 1
    if mode == "count":
        offs = torch.arange(width, device=q.device)
        idx = torch.clamp(lo[:, None] + offs, max=last)
        valid = offs[None, :] <= (hi - lo)[:, None]
        cnt = (le(take(sk, idx), q[:, None]) & valid).sum(dim=1)
        return lo + torch.clamp(cnt - 1, min=0)
    if mode == "adaptive":
        hi = torch.clamp(hi, max=last)
        for _ in range(int(width).bit_length()):
            live = lo < hi
            mid = torch.where(live, (lo + hi + 1) >> 1, torch.zeros_like(lo))
            go = live & le(take(sk, mid), q)
            lo = torch.where(go, mid, lo)
            hi = torch.where(live & ~go, mid - 1, hi)
        return lo
    if mode != "bisect":
        raise ValueError(f"unknown search mode {mode!r}")
    for _ in range(trips):
        mid = (lo + hi + 1) >> 1
        go = le(take(sk, torch.clamp(mid, max=last)), q)
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    return lo


def _base(q, sk, spos, seg, *, eps_eff: int, n_data: int, window: int):
    # min(max(.)) order, as jnp.clip
    seg = torch.clamp(torch.clamp(seg, min=0), max=sk.numel() - 2)
    pred = interp(sk, spos, q, seg)
    base = torch.floor(pred).long() - eps_eff
    return torch.clamp(base, 0, n_data - window).int()


def radix_window(table, d, shift, p_max, off=0):
    """Inclusive window ``[lo, hi]`` of spline indices from the radix table
    (its row at ``off``) for the u64 differences ``d = q - min`` (0 below
    min): the table pair at the prefix ``d >> shift`` saturated at
    ``p_max`` (R5; ``shift``, ``p_max`` and ``off`` are ints or one per
    query)."""
    p = shr_sat(d, shift, p_max) + off
    lo = torch.clamp(take(table, p).long() - 1, min=0)
    hi = torch.clamp(take(table, p + 1).long() - 1, min=0)
    return lo, hi


def radix_geometry(max_win: int) -> tuple[int, int]:
    """(count width, bisect trips) of the radix spline window."""
    return max_win, max(int(max_win - 1).bit_length(), 0)


def cht_geometry(delta: int) -> tuple[int, int]:
    """(count width, bisect trips) of the CHT spline window."""
    return delta + 1, max(int(delta).bit_length(), 0)


def radix_window_base(q, table, sk, spos, *, shift: int, r: int,
                      min_key: int, max_win: int, eps_eff: int, n_data: int,
                      window: int, mode: str) -> torch.Tensor:
    """Plain K2: int32 window bases of biased int64 queries ``q`` through a
    radix table (int32 ``table``, biased ``min_key``)."""
    mk = torch.tensor(min_key, dtype=torch.int64, device=q.device)
    d = torch.where(lt(q, mk), torch.zeros_like(q), diff(q, mk))
    lo, hi = radix_window(table, d, shift, (1 << r) - 1)
    width, trips = radix_geometry(max_win)
    seg = _predecessor(q, sk, lo, hi, width=width, trips=trips, mode=mode)
    return _base(q, sk, spos, seg, eps_eff=eps_eff, n_data=n_data,
                 window=window)


def cht_window_base(q, cells, sk, spos, *, r: int, levels: int, delta: int,
                    eps_eff: int, n_data: int, window: int,
                    mode: str) -> torch.Tensor:
    """Plain K3: int32 window bases of biased int64 queries ``q`` through
    a CHT (``cells``: the uint32 cells viewed as int32)."""
    node = torch.zeros_like(q)
    out = torch.zeros_like(q)
    done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    for level in range(levels):
        cell = take(cells, node * (1 << r)
                    + extract_bits(q, level * r, r)).long()
        is_child = cell < 0                       # top bit of the u32 cell
        val = cell & 0x7FFFFFFF
        out = torch.where(~done & ~is_child, val, out)
        node = torch.where(~done & is_child, val, node)
        done = done | ~is_child
    hi = torch.clamp(out + delta, max=sk.numel() - 1)
    width, trips = cht_geometry(delta)
    seg = _predecessor(q, sk, out, hi, width=width, trips=trips, mode=mode)
    return _base(q, sk, spos, seg, eps_eff=eps_eff, n_data=n_data,
                 window=window)


# ----------------------------------------------------------------- kernel --

class _SegParams(ctypes.Structure):
    """Mirror of ``SegParams`` in ``csrc/segment_lookup.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "sk", "spos", "table", "cells", "out", "dk", "s1", "s2")] + [
        (name, ctypes.c_int64) for name in ("n_q", "min_key", "n_row",
                                            "n1")] + [
        (name, ctypes.c_int32) for name in (
            "n_spline", "eps_eff", "base_max", "shift", "p_max",
            "search_width", "search_trips", "r", "levels", "delta",
            "window")]


def _launch(cht: bool, q, layer, sk, spos, *, eps_eff, n_data, window,
            mode, probe=None, **geom) -> torch.Tensor:
    """One kernel launch over ``q`` on the current stream (no sync, no
    allocation inside the kernel). With ``probe`` (the planes whose data
    plane and key summary K4 reads), the fused form: first indices >= q
    instead of window bases."""
    global launches, fused_launches
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = load_library("segment_lookup")
    check_params_size(lib, "segment_params_size", _SegParams)
    dev = q.device
    if mode not in SEARCH_FORMS:
        raise ValueError(f"unknown search mode {mode!r}")
    if q.numel() >= (1 << 31):
        raise ValueError("a launch takes fewer than 2^31 queries")
    if sk.numel() < 2 or sk.numel() != spos.numel():
        raise ValueError("spline planes need >= 2 points of equal count")
    if n_data - window < 0:
        raise ValueError("data plane shorter than its window")
    n = q.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    p = _SegParams()
    p.q = device_ptr("queries", q, torch.int64, dev)
    p.sk = device_ptr("sk", sk, torch.int64, dev)
    p.spos = device_ptr("spos", spos, torch.float32, dev)
    if cht:
        p.cells = device_ptr("cells", layer, torch.int32, dev)
    else:
        p.table = device_ptr("table", layer, torch.int32, dev)
        if layer.numel() != (1 << geom["r"]) + 1:
            raise ValueError("radix table must hold 2^r + 1 entries")
    levels = 0
    if probe is not None:
        sm = probe.summary
        if sm.row != probe.dk.numel() or probe.dk.numel() < n_data:
            raise ValueError("data plane and summary do not match the "
                             "planes")
        p.dk = device_ptr("data plane", probe.dk, torch.int64, dev)
        p.s1 = device_ptr("summary level 1", sm.l1, torch.int64, dev)
        p.s2 = device_ptr("summary level 2", sm.l2, torch.int64, dev)
        p.n_row = sm.row
        p.n1 = sm.n1
        levels = sm.levels
    p.out = out.data_ptr()
    p.n_q = n
    p.n_spline = sk.numel()
    p.eps_eff = eps_eff
    p.base_max = n_data - window
    p.window = window
    for name, v in geom.items():
        setattr(p, name, v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.plex_segment_lookup(ctypes.addressof(p), int(cht),
                                  SEARCH_FORMS.index(mode), levels, stream)
    check_launch(lib, "segment_error_string", err, "segment_lookup")
    if probe is None:
        launches += 1
    else:
        fused_launches += 1
    return out


def radix_segment_lookup(q, table, sk, spos, *, shift: int, r: int,
                         min_key: int, max_win: int, eps_eff: int,
                         n_data: int, window: int,
                         mode: str = "count", probe=None) -> torch.Tensor:
    """K2: int32 window bases [B] through a radix-table layer (with
    ``probe``, the fused form: first indices >= q). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        base = radix_window_base(
            q, table, sk, spos, shift=shift, r=r, min_key=min_key,
            max_win=max_win, eps_eff=eps_eff, n_data=n_data, window=window,
            mode=mode)
        return base if probe is None else _probe_plain(probe, q, base)
    width, trips = radix_geometry(max_win)
    return _launch(False, q, table, sk, spos, eps_eff=eps_eff,
                   n_data=n_data, window=window, mode=mode, probe=probe,
                   min_key=min_key, shift=shift, p_max=(1 << r) - 1, r=r,
                   search_width=width, search_trips=trips)


def cht_segment_lookup(q, cells, sk, spos, *, r: int, levels: int,
                       delta: int, eps_eff: int, n_data: int, window: int,
                       mode: str = "count", probe=None) -> torch.Tensor:
    """K3: int32 window bases [B] through a CHT layer (with ``probe``, the
    fused form: first indices >= q). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if (levels - 1) * r >= 64:
        raise ValueError("CHT descends past 64 key bits")
    if q.device.type == "cpu":
        base = cht_window_base(
            q, cells, sk, spos, r=r, levels=levels, delta=delta,
            eps_eff=eps_eff, n_data=n_data, window=window, mode=mode)
        return base if probe is None else _probe_plain(probe, q, base)
    width, trips = cht_geometry(delta)
    return _launch(True, q, cells, sk, spos, eps_eff=eps_eff, n_data=n_data,
                   window=window, mode=mode, probe=probe, r=r,
                   levels=levels, delta=delta, search_width=width,
                   search_trips=trips)


def _probe_plain(pp: PlexPlanes, q, base):
    """K4's summary probe (``bounded_search``'s bisect form) on ``base``."""
    return bounded_search_plain(pp.dk, q, base, window=pp.window,
                                mode="bisect", summary=pp.summary)


def search_width(pp: PlexPlanes) -> int:
    """Widest spline window of ``pp``'s layer (the count form's width)."""
    s = pp.static
    return s["max_win"] if pp.kind == "radix" else s["delta"] + 1


def _plane_call(pp: PlexPlanes, mode: str):
    """The layer array and the keyword statics of ``pp`` for K2 or K3."""
    s = pp.static
    common = dict(eps_eff=pp.eps_eff, n_data=pp.n_data, window=pp.window,
                  mode=mode)
    if pp.kind == "radix":
        return pp.layer_arrays["table"], dict(
            common, shift=s["shift"], r=s["r"], min_key=s["min_key"],
            max_win=s["max_win"])
    return pp.layer_arrays["cells"], dict(
        common, r=s["r"], levels=s["levels"], delta=s["delta"])


def _mode(pp: PlexPlanes, q: torch.Tensor, mode: str | None) -> str:
    if mode is not None:
        return mode
    return CARD_FORM if q.device.type == "cuda" else pp.static["mode"]


def _run(pp: PlexPlanes, q: torch.Tensor, mode: str | None, probe):
    if q.device != pp.device:
        raise ValueError(f"queries on {q.device}, planes on {pp.device}")
    layer, kw = _plane_call(pp, _mode(pp, q, mode))
    fn = radix_segment_lookup if pp.kind == "radix" else cht_segment_lookup
    return fn(q, layer, pp.sk, pp.spos, probe=probe, **kw)


def window_base(pp: PlexPlanes, q: torch.Tensor,
                mode: str | None = None) -> torch.Tensor:
    """K2 or K3, by the planes' layer kind, over biased queries on the
    planes' device (one launch on a CUDA device). ``mode``: the search form
    (default: ``CARD_FORM`` on the card, the planes' on the CPU)."""
    return _run(pp, q, mode, None)


def window_base_plain(pp: PlexPlanes, q: torch.Tensor,
                      mode: str | None = None) -> torch.Tensor:
    """The plain version of ``window_base`` on any device (default form:
    the planes' ``mode``)."""
    layer, kw = _plane_call(pp, mode or pp.static["mode"])
    fn = radix_window_base if pp.kind == "radix" else cht_window_base
    return fn(q, layer, pp.sk, pp.spos, **kw)


def window_probe(pp: PlexPlanes, q: torch.Tensor,
                 mode: str | None = None) -> torch.Tensor:
    """K2 or K3 fused with K4: int32 first indices >= q over the planes'
    data plane (``bounded_search``'s summary probe on ``window_base``), in
    one launch on a CUDA device."""
    return _run(pp, q, mode, pp)


def window_probe_plain(pp: PlexPlanes, q: torch.Tensor,
                       mode: str | None = None) -> torch.Tensor:
    """The plain version of ``window_probe``: ``bounded_search_plain``
    applied to ``window_base_plain``, exactly."""
    return _probe_plain(pp, q, window_base_plain(pp, q, mode))
