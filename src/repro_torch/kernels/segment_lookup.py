"""K2 and K3: the single-index segment lookup, plain PyTorch version and
CUDA kernel wrapper (the port of the single-index half of
``repro.kernels.plex_segment_lookup``).

Per query, the base of its eps window over the data plane:

1. window over spline points: radix prefix ``(q - min) >> shift`` (0 below
   min, clipped to ``2^r - 1``) bounded by ``table[p] - 1`` and
   ``table[p + 1] - 1`` floored at 0 (K2), or a CHT
   descent over ``levels`` cells, top bit = child, then
   ``[out, min(out + delta, n_spline - 1)]`` (K3);
2. spline predecessor in that window, by count or by fixed-trip bisect;
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
tensors, never a fallback between them. The reference hands its CHT kernel
an int32 ``[levels, B]`` bins plane; here the bins come from the key
(``keys.extract_bits``, in the kernel too), so none is materialised.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_params_size, device_ptr, load_library
from .keys import diff, diff_to_f32, extract_bits, le, lt, take
from .planes import PlexPlanes

# kernel launches of the two wrappers on CUDA tensors (plain integer; set to
# 0 before a run and read after it to see which path ran)
launches = 0


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
    count over ``width`` keys, or ``trips`` bisect rounds."""
    last = sk.numel() - 1
    if mode == "count":
        offs = torch.arange(width, device=q.device)
        idx = torch.clamp(lo[:, None] + offs, max=last)
        valid = offs[None, :] <= (hi - lo)[:, None]
        cnt = (le(take(sk, idx), q[:, None]) & valid).sum(dim=1)
        return lo + torch.clamp(cnt - 1, min=0)
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
    p_max = (1 << r) - 1
    if shift:
        # logical shift of the u64 bit pattern: non-negative in int64
        pfx = (d >> shift) & ((1 << (64 - shift)) - 1)
        p = torch.clamp(pfx, max=p_max)
    else:
        # a negative int64 is a u64 difference >= 2^63
        p = torch.where(d < 0, p_max, torch.clamp(d, max=p_max))
    lo = torch.clamp(take(table, p).long() - 1, min=0)
    hi = torch.clamp(take(table, p + 1).long() - 1, min=0)
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
        "q", "sk", "spos", "table", "cells", "out")] + [
        (name, ctypes.c_int64) for name in ("n_q", "min_key")] + [
        (name, ctypes.c_int32) for name in (
            "n_spline", "eps_eff", "base_max", "shift", "p_max",
            "search_width", "search_trips", "r", "levels", "delta")]


def _launch(cht: bool, q, layer, sk, spos, *, eps_eff, n_data, window,
            mode, **geom) -> torch.Tensor:
    """One kernel launch over ``q`` on the current stream (no sync, no
    allocation inside the kernel)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = load_library("segment_lookup")
    check_params_size(lib, "segment_params_size", _SegParams)
    dev = q.device
    if mode not in ("count", "bisect"):
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
    p.out = out.data_ptr()
    p.n_q = n
    p.n_spline = sk.numel()
    p.eps_eff = eps_eff
    p.base_max = n_data - window
    for name, v in geom.items():
        setattr(p, name, v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.plex_segment_lookup(ctypes.addressof(p), int(cht),
                                  int(mode == "bisect"), stream)
    check_launch(lib, "segment_error_string", err, "segment_lookup")
    launches += 1
    return out


def radix_segment_lookup(q, table, sk, spos, *, shift: int, r: int,
                         min_key: int, max_win: int, eps_eff: int,
                         n_data: int, window: int,
                         mode: str = "count") -> torch.Tensor:
    """K2: int32 window bases [B] through a radix-table layer. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return radix_window_base(
            q, table, sk, spos, shift=shift, r=r, min_key=min_key,
            max_win=max_win, eps_eff=eps_eff, n_data=n_data, window=window,
            mode=mode)
    width, trips = radix_geometry(max_win)
    return _launch(False, q, table, sk, spos, eps_eff=eps_eff,
                   n_data=n_data, window=window, mode=mode, min_key=min_key,
                   shift=shift, p_max=(1 << r) - 1, r=r, search_width=width,
                   search_trips=trips)


def cht_segment_lookup(q, cells, sk, spos, *, r: int, levels: int,
                       delta: int, eps_eff: int, n_data: int, window: int,
                       mode: str = "count") -> torch.Tensor:
    """K3: int32 window bases [B] through a CHT layer. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if (levels - 1) * r >= 64:
        raise ValueError("CHT descends past 64 key bits")
    if q.device.type == "cpu":
        return cht_window_base(
            q, cells, sk, spos, r=r, levels=levels, delta=delta,
            eps_eff=eps_eff, n_data=n_data, window=window, mode=mode)
    width, trips = cht_geometry(delta)
    return _launch(True, q, cells, sk, spos, eps_eff=eps_eff, n_data=n_data,
                   window=window, mode=mode, r=r, levels=levels, delta=delta,
                   search_width=width, search_trips=trips)


def _plane_call(pp: PlexPlanes):
    """The layer array and the keyword statics of ``pp`` for K2 or K3."""
    s = pp.static
    common = dict(eps_eff=pp.eps_eff, n_data=pp.n_data, window=pp.window,
                  mode=s["mode"])
    if pp.kind == "radix":
        return pp.layer_arrays["table"], dict(
            common, shift=s["shift"], r=s["r"], min_key=s["min_key"],
            max_win=s["max_win"])
    return pp.layer_arrays["cells"], dict(
        common, r=s["r"], levels=s["levels"], delta=s["delta"])


def window_base(pp: PlexPlanes, q: torch.Tensor) -> torch.Tensor:
    """K2 or K3, by the planes' layer kind, over biased queries on the
    planes' device (one launch on a CUDA device)."""
    if q.device != pp.device:
        raise ValueError(f"queries on {q.device}, planes on {pp.device}")
    layer, kw = _plane_call(pp)
    fn = radix_segment_lookup if pp.kind == "radix" else cht_segment_lookup
    return fn(q, layer, pp.sk, pp.spos, **kw)


def window_base_plain(pp: PlexPlanes, q: torch.Tensor) -> torch.Tensor:
    """The plain version of ``window_base`` on any device."""
    layer, kw = _plane_call(pp)
    fn = radix_window_base if pp.kind == "radix" else cht_window_base
    return fn(q, layer, pp.sk, pp.spos, **kw)
