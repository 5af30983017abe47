#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--serve-keys 200000000]

Builds the port's CUDA kernel from this checkout's sources, holds it against
its plain PyTorch version on the card, then drives the port's main path — a
PlexService over 200M SOSD-scale ``amzn`` keys answering lookup requests,
merged lookups after inserts and deletes, and a merge — and checks every
answer against ``np.searchsorted``. Each phase prints one JSON line; the
``kernels`` line carries each kernel's launches on the main path, its time,
its plain version's time, its bound and a library yardstick; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Exits non-zero, printing no result, without a CUDA device, outside a checkout
of the repository, or when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
U64_MAX = (1 << 64) - 1
SERVE_KEYS = 200_000_000          # SOSD scale: the paper's datasets
KERNEL_KEYS = 16_000_000          # two 8M shards
QUERIES = 1 << 20                 # per request
REQUESTS = 8
MERGED_REQUESTS = 4
BLOCK = 65536
DELTA_CAP = 4096
# HBM rate of one H100 SXM (NVIDIA's data sheet, at 700 W): the bound's
# denominator; the measured copy rate is printed beside it
PEAK_HBM_TBS = 3.35


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def make_queries(keys: np.ndarray, n: int, rng) -> np.ndarray:
    """90% present keys, 10% absent (uniform over the key range, plus 0 and
    2^64 - 1), shuffled."""
    n_abs = n // 10
    present = keys[rng.integers(0, keys.size, n - n_abs)]
    absent = rng.integers(keys[0], keys[-1], n_abs - 2, dtype=np.uint64,
                          endpoint=True)
    q = np.concatenate([present, absent,
                        np.asarray([0, U64_MAX], np.uint64)])
    return q[rng.permutation(q.size)]


def device_ms(fn, device, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on ``device`` (CUDA events on the card,
    after one warm-up call)."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_chunked(sp, probe, q, delta, chunk: int = BLOCK):
    """The plain version over ``q`` in ``chunk``-sized pieces (its count
    modes build [chunk, window] gathers)."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    parts = [SL.stacked_lookup_plain(sp, probe, q[i:i + chunk], delta)
             for i in range(0, q.numel(), chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


# ------------------------------------------------------------------ env ----

def phase_env(device) -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    from repro_torch.kernels._build import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    info = dict(card=smi[0] if smi else "unknown",
                name=torch.cuda.get_device_name(device),
                count=torch.cuda.device_count(), torch=torch.__version__,
                cuda=torch.version.cuda, nvcc=nvcc,
                python=sys.version.split()[0])
    emit("env", **info)
    return info


def measure_bandwidth(device) -> float:
    """Device-memory rate in GB/s from a 2 GiB device-to-device copy (bytes
    read + written over its CUDA-event time)."""
    import torch
    x = torch.empty(1 << 28, dtype=torch.int64, device=device)
    y = torch.empty_like(x)
    ms = device_ms(lambda: y.copy_(x), device, reps=10)
    del x, y
    return 2 * (1 << 31) / (ms * 1e-3) / 1e9


# ---------------------------------------------------------------- build ----

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln][:16]
    emit("build", seconds=secs, libraries=sorted(paths), ptxas=ptxas,
         flags=" ".join(_build.NVCC_FLAGS))


# --------------------------------------------------------------- kernel ----

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _forced(plexes, kind):
    """The shard PLEXes with the layer forced to ``kind`` (neighbouring
    shards differ in radix width or CHT delta)."""
    import dataclasses
    from repro_torch.core import build_cht, build_radix_table
    out = []
    for i, px in enumerate(plexes):
        if kind == "radix" and px.tuning.kind != "radix":
            px = dataclasses.replace(px, layer=build_radix_table(
                px.spline.keys, 16 + i % 2))
        elif kind == "cht":
            px = dataclasses.replace(px, layer=build_cht(
                px.spline.keys, 6, 32 + 16 * (i % 2)))
        out.append(px)
    return out


def phase_kernel(device, seed: int, n_keys: int, n_queries: int) -> dict:
    """All 16 variants of the kernel against the plain version, exactly."""
    import torch
    from repro_torch.core import build_plex, shard_offsets
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.planes import build_stacked_planes
    from repro_torch.serving.delta import DeltaBuffer
    rng = np.random.default_rng(seed)
    keys = generate("amzn", n_keys, seed)
    offs = shard_offsets(keys, 2)
    plexes = [build_plex(keys[lo:hi], 64)
              for lo, hi in zip(offs, np.append(offs[1:], keys.size))]
    buf = DeltaBuffer(keys, capacity=DELTA_CAP)
    buf.insert(rng.integers(keys[0], keys[-1], 3_000, dtype=np.uint64))
    buf.delete(keys[rng.integers(0, keys.size, 1_000)])
    q_np = make_queries(keys, n_queries, rng)
    q = torch.from_numpy(to_biased(q_np)).to(device)
    delta = buf.device_view(device)
    results = []
    for kind in ("radix", "cht"):
        sp = build_stacked_planes(_forced(plexes, kind), offs, device)
        check(sp is not None and sp.kind == kind, f"{kind} planes")
        for mode in ("count", "bisect"):
            sp.static["mode"] = mode
            for probe in ("count", "bisect"):
                for dp in (None, delta):
                    before = SL.launches
                    got = SL.stacked_lookup(sp, probe, q, dp, aux=True)
                    launches = SL.launches - before
                    want = plain_chunked(sp, probe, q, dp)
                    match = all(torch.equal(g, w) for g, w in zip(got, want))
                    err = max(int((g.long() - w.long()).abs().max())
                              for g, w in zip(got, want))
                    row = dict(kind=kind, spline=mode, probe=probe,
                               cap=dp.cap if dp is not None else 0,
                               launches=launches, match=match,
                               max_abs_err=err,
                               kernel_ms=device_ms(lambda: SL.stacked_lookup(
                                   sp, probe, q, dp), device),
                               plain_ms=device_ms(lambda: plain_chunked(
                                   sp, probe, q, dp), device, reps=2))
                    results.append(row)
                    emit("kernel", **row)
                    check(match and launches == (device.type == "cuda"),
                          f"kernel variant failed: {row}")
        del sp
    return dict(variants=len(results),
                max_abs_err=max(r["max_abs_err"] for r in results))


# ---------------------------------------------------------------- serve ----

def _kinds(snap) -> dict:
    kinds: dict = {}
    for px in snap.shards:
        k = type(px.layer).__name__
        kinds[k] = kinds.get(k, 0) + 1
    return kinds


class recorded_launches:
    """Within the block, every ``stacked_lookup`` call that serving makes
    is passed through and its arguments kept in ``calls``: the served
    request's own launches, replayed afterwards for device times and for
    the comparison with the plain version."""

    def __enter__(self):
        from repro_torch.kernels import stacked_lookup as SL
        self.calls, self._orig = [], SL.stacked_lookup

        def record(sp, probe, q, delta=None, **kw):
            self.calls.append((sp, probe, q, delta))
            return self._orig(sp, probe, q, delta, **kw)
        SL.stacked_lookup = record
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import stacked_lookup as SL
        SL.stacked_lookup = self._orig


def replay(calls, device) -> dict:
    """The recorded launches again, on the same device tensors: each held
    against the plain version exactly (ranks, shard ids, window bases),
    then both timed with CUDA events. Made after the main path's counts
    were read, so these launches are not counted as the main path's."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    err = 0
    for sp, probe, q, delta in calls:
        got = SL.stacked_lookup(sp, probe, q, delta, aux=True)
        want = SL.stacked_lookup_plain(sp, probe, q, delta)
        err = max([err] + [int((g.long() - w.long()).abs().max())
                           for g, w in zip(got, want)])
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"kernel differs from its plain version on a served launch "
              f"of {q.numel()} queries over {sp.n_shards} shard(s)")

    def run(fn):
        return lambda: [fn(sp, probe, q, delta)
                        for sp, probe, q, delta in calls]
    return dict(max_abs_err=err,
                kernel_ms=device_ms(run(SL.stacked_lookup), device, reps=3),
                plain_ms=device_ms(run(SL.stacked_lookup_plain), device,
                                   reps=1))


def bound_bytes(snap, q: np.ndarray) -> int:
    """Bytes one request's launches must move at least: each query's 8 B
    key read and 4 B rank written, and once each over the request every
    distinct 32 B sector holding a key the answer rests on: the data-plane
    key at the query's rank in its shard, and the spline keys (8 B) and
    ranks (4 B) at both ends of its segment. Counted on the host from this
    request's data. Layer cells, shard minima and delta keys are left out,
    so the count errs low."""
    sid = snap.route(q)
    rank = np.searchsorted(snap.keys, q, "left")
    ends = np.append(snap.offsets[1:], snap.n_keys)
    sectors = 0
    for s in np.unique(sid):
        mine = sid == s
        local = np.clip(rank[mine] - snap.offsets[s], 0,
                        ends[s] - snap.offsets[s])
        sk = snap.shards[s].spline.keys
        seg = np.clip(np.searchsorted(sk, q[mine], "right") - 1, 0,
                      max(sk.size - 2, 0))
        sectors += np.unique(local // 4).size
        sectors += np.unique(np.concatenate([seg // 4, (seg + 1) // 4])).size
        sectors += np.unique(np.concatenate([seg // 8, (seg + 1) // 8])).size
    return q.size * (8 + 4) + 32 * sectors


def phase_serve(device, seed: int, n_keys: int, n_queries: int) -> dict:
    import torch
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.kernels.keys import to_biased
    from repro_torch.serving import PlexService
    if n_keys < SERVE_KEYS:
        emit("reduced", serve_keys=n_keys, of=SERVE_KEYS)
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    keys = generate("amzn", n_keys, seed)
    gen_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    svc = PlexService(keys, eps=64, block=BLOCK, device=device)
    ctor_s = time.perf_counter() - t0
    snap = svc.snapshot
    emit("serve_setup", keys=n_keys, generate_s=gen_s,
         build_s=snap.build_s, planes_upload_s=ctor_s - snap.build_s,
         shards=snap.n_shards, path="fused" if svc.fused else "per-shard",
         layer_kinds=_kinds(snap), block=BLOCK,
         max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None))

    requests = [("lookup", make_queries(keys, n_queries, rng))
                for _ in range(REQUESTS)]
    records, calls = [], []
    # ---- the main path: counts at 0 just before, read just after
    SL.launches = 0
    batches0 = svc.stats.batches
    for i, (what, q) in enumerate(requests):
        rec, launched = _serve_request(svc, what, i, q, keys)
        records.append(rec)
        calls.append(launched)
    svc.insert(rng.integers(keys[0], keys[-1], 3_000, dtype=np.uint64))
    svc.delete(keys[rng.integers(0, keys.size, 1_000)])
    check(svc.n_pending > 0 and svc.stats.merges == 0, "delta must be live")
    logical = svc.logical_keys()
    for i in range(MERGED_REQUESTS):
        q = make_queries(logical, n_queries, rng)
        requests.append(("merged", q))
        rec, launched = _serve_request(svc, "merged", i, q, logical)
        records.append(rec)
        calls.append(launched)
    main_launches = SL.launches
    main_batches = svc.stats.batches - batches0
    # ---- end of the main path
    if device.type == "cuda":
        check(0 < main_launches == main_batches,
              f"launches {main_launches} != micro-batches {main_batches}")

    # the served launches replayed: exact against the plain version, timed
    dk_sorted = torch.from_numpy(to_biased(keys)).to(device)
    for rec, (what, q), launched in zip(records, requests, calls):
        rec.update(replay(launched, device), matches_plain=True,
                   bound_ms=bound_bytes(snap, q) / (PEAK_HBM_TBS * 1e12)
                   * 1e3)
        qd = torch.from_numpy(to_biased(q)).to(device)
        rec["library_ms"] = device_ms(
            lambda: torch.searchsorted(dk_sorted, qd), device, reps=3)
        emit("serve_request", **rec)
    del dk_sorted

    def mean(key):
        return float(np.mean([r[key] for r in records]))
    request_s = sum(r["request_ms"] for r in records) / 1e3
    out = dict(requests=len(records), launches=main_launches,
               micro_batches=main_batches, kernel_ms=mean("kernel_ms"),
               plain_ms=mean("plain_ms"), library_ms=mean("library_ms"),
               bound_ms=mean("bound_ms"), peak_hbm_tbs=PEAK_HBM_TBS,
               max_abs_err=max(r["max_abs_err"] for r in records),
               matches_plain=True,
               lookups_per_s=sum(r["queries"] for r in records) / request_s,
               p99_request_ms=float(np.percentile(
                   [r["request_ms"] for r in records], 99)),
               kernel_share_of_request=sum(r["kernel_ms"] for r in records)
               / (request_s * 1e3),
               path="fused" if svc.fused else "per-shard")
    emit("serve", **out)
    emit("yardstick", library="torch.searchsorted", library_ms=out[
        "library_ms"], queries=n_queries, keys=n_keys)
    emit("serve_profile", path=out["path"],
         top_tottime_ms=profile_request(svc, requests[-1][1]))
    return out


def profile_request(svc, q, top: int = 10) -> list:
    """Where one request's host time goes: ``cProfile`` over one
    ``lookup``, the functions with the most own time (ms). Native calls
    (numpy, torch) show under their own names."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    svc.lookup(q)
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [[f"{pathlib.Path(f).name}:{line}:{fn}", tt * 1e3]
            for (f, line, fn), (_, _, tt, _, _) in rows]


def _serve_request(svc, what, i, q, logical):
    """One served request, checked against searchsorted over ``logical``;
    returns its record and the launches it made (``recorded_launches``)."""
    from repro_torch.kernels import stacked_lookup as SL
    l0, b0 = SL.launches, svc.stats.batches
    with recorded_launches() as rec:
        t0 = time.perf_counter()
        got = svc.lookup(q)
        req_s = time.perf_counter() - t0
    want = np.searchsorted(logical, q, "left")
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(f"{what} request {i}: {bad.size} of {q.size} "
                             f"ranks differ from searchsorted, e.g. "
                             f"q={q[bad[0]]} got={got[bad[0]]} "
                             f"want={want[bad[0]]}")
    launches, batches = SL.launches - l0, svc.stats.batches - b0
    if svc.device.type == "cuda" and launches != batches:
        raise AssertionError(f"{launches} launches for {batches} batches")
    return dict(kind=what, index=i, queries=int(q.size),
                request_ms=req_s * 1e3, request_lookups_per_s=q.size / req_s,
                launches=launches, micro_batches=batches,
                matches_searchsorted=True), rec.calls


# ---------------------------------------------------------------- merge ----

def phase_merge(device, seed: int, n_keys: int, n_queries: int) -> dict:
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.serving import PlexService
    rng = np.random.default_rng(seed + 2)
    keys = generate("amzn", n_keys, seed)
    svc = PlexService(keys, eps=64, block=BLOCK, device=device)
    svc.insert(rng.integers(keys[0], keys[-1], 2_000, dtype=np.uint64))
    svc.delete(keys[rng.integers(0, keys.size, 500)])
    t0 = time.perf_counter()
    merged = svc.merge()
    merge_s = time.perf_counter() - t0
    logical = svc.logical_keys()
    q = make_queries(logical, n_queries, rng)
    SL.launches = 0
    with recorded_launches() as rec:
        got = svc.lookup(q)
    launches = SL.launches
    replay(rec.calls, device)
    ok = merged and svc.n_pending == 0 and np.array_equal(
        got, np.searchsorted(logical, q, "left"))
    out = dict(merged=bool(merged), merge_s=merge_s, keys=int(logical.size),
               launches=launches, matches_searchsorted=bool(ok),
               path="fused" if svc.fused else "per-shard")
    emit("merge", **out)
    if not ok or (device.type == "cuda" and launches <= 0):
        raise AssertionError(f"merge phase failed: {out}")
    return out


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-keys", type=int, default=SERVE_KEYS)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    info = phase_env(device)
    phase_build()
    emit("bandwidth", measured_gbs=measure_bandwidth(device),
         published_tbs=PEAK_HBM_TBS, card=info["card"])
    kern = phase_kernel(device, args.seed, KERNEL_KEYS, QUERIES)
    serve = phase_serve(device, args.seed, args.serve_keys, QUERIES)
    phase_merge(device, args.seed, KERNEL_KEYS, QUERIES)
    print(json.dumps({"kernels": [{
        "name": "stacked_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stacked_lookup.cu",
        "replaces": "src/repro/kernels/stacked_pallas.py:85",
        "launches": serve["launches"],
        "max_abs_err": max(kern["max_abs_err"], serve["max_abs_err"]),
        "ms": serve["kernel_ms"], "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": "bytes",
        "library_ms": serve["library_ms"], "matches_plain": True}]}),
        flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
