#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--serve-keys 200000000]
                          [--index-keys 16777216]

Builds the port's CUDA kernels (and ``tools/segment_split.cu``) from this
checkout's sources, holds each against its plain PyTorch version on the
card, then drives the port's three paths:

* serving (K1): every kernel variant against the plain version, each
  also with the hot-key cache (a cold pass, a warm pass whose every lane
  hits, and the tear stress: 2^20 lanes over 64 keys of one slot, 100
  launches) and with the counter plane, and keys far past the end of a
  narrow radix shard against ``np.searchsorted`` (R5); a PlexService over
  200M SOSD-scale ``amzn`` keys answering lookup requests, merged lookups
  after inserts and deletes, and a merge; each request's launches replayed
  as served (the overlap of programmatic dependent launch included), with
  one summary level against two and overlap against none, and K4 on the
  200M-key plane, one level against two; the same 200M keys built again
  by the process-pool build (``Snapshot.build(workers=)``, spawned workers,
  none holding a CUDA context) and held bit for bit to the serial build;
* the routed path (``distrib``): that 200M-key snapshot placed over 1, 2, 4
  and 8 slots of the card (and the fewest slots at which every slot
  unifies): each plan, which slots unify, and where it partitions, eight
  requests through K1 on every slot's own stream in turns with the
  per-shard service on the same queries (launches a slot, launches that
  overlap another slot's, K1's time a slot as served); a 4-slot service of
  16M keys through inserts, deletes, a merge that re-plans and a slot that
  fails to load at the next merge (a ``device.loss`` bundle, 3 slots
  left) (``routed``); and ``plan_from_dir`` with ``open_routed`` over 4
  slots on the generation ``durable`` persisted, each slot mapping less
  than a full load (``routed_partial_load``);
* the serving front end: a fused, cached service over 200M keys of an SOSD
  dataset whose shards unify, on Zipf(1.2) traffic: requests with the
  cache cold and warm, counted (live hotness and the probe histogram),
  with a live delta, and with the cache off (``serve_cache``); 64 tickets
  through ``submit`` filled by the deadline timer (``serve_queue``); the
  same service observed: requests with observability off, disarmed,
  counting and under the armed flight recorder with an SLO watchdog, in
  turns (launch counts, the reference's overhead budgets, the span split
  of a request's host time beside K1's device time; ``observe``); a
  background-merging service taking rounds of inserts and deletes while
  it answers lookups (``merge_background``);
* durable, fault-tolerant serving: that cached service saved with fsync,
  updated through its WAL, dropped with a torn WAL record, reopened by
  ``PlexService.open`` and serving through K1, then a durable merge over
  the process pool, all traced (``durable``); a 2M-key service that asked for the fallback chain, with
  ``backend.dispatch`` failing for ``cuda`` (``fail_n(3)``, ``always()``,
  ``intermittent(0.3)``), answered through the chain by the ``torch``
  backend on the card, the breaker's states on an injected clock, K1 back
  after the faults clear; a service left at its default fallback raising
  rather than serving when K1's dispatch fails or its library does not
  load; ``open`` falling back to the last known good generation and a
  merge whose build fails, with an incident manager writing a bundle for
  each kind and the breaker's transitions traced (``chaos``);
* the example drills: ``main`` of each ``repro_torch.launch`` drill
  (quickstart, save_open, mesh_serve, chaos_drill, serve_paged) on the
  card, each returning 0 under its own assertions, with its seconds and
  its launches of K1, the fused ``window_probe`` and K5; quickstart must
  launch ``window_probe``, save_open and mesh_serve K1 (``examples``);
* the per-index path (K2/K3 fused with K4 in one launch): ``LearnedIndex.
  lookup`` over 2^24 keys of each SOSD dataset (the most one index's float32
  rank plane holds), K2/K3 alone, K4 alone and the fused launch each held
  to its plain version, K2/K3's time split by ``tools/segment_split.py``
  (parts alone, each search form, the fused launch against the pair it
  replaces, in turns), then the {radix, CHT} x {spline count, bisect,
  adaptive} x {probe count, bisect} matrix with the fused launch in each
  form; every rank checked against ``np.searchsorted``; K4's summary probe
  timed with one level against two;
* LM serving (K5): the flash-attention kernels against their plain version,
  bf16 on the Hopper kernel (wgmma, TMA) and f32 on the SIMT one, the bf16
  cases also held to the exact function in float64 (phase ``attention``);
  minitron-4b at full width with random weights, a batched prefill of
  32,768 tokens (one K5 launch a layer, each replayed in bf16 through the
  plain version with tensor-core scores and through the plain version, and
  its first rows held to float64; then timed again unrecorded) and a
  float32 check of prefill against token-by-token decode (``lm_prefill``);
  then the ``ServeEngine`` over ten requests whose position groups split,
  at the model's first ``ENGINE_LAYERS`` layers, and the whole model's
  decode step profiled (``lm_serve``);
* the MoE family (``lm_moe``): deepseek-v2 at full width cut to 3 layers
  (MLA, the dense layer 0 and two MoE layers of 160 experts), a 4,096-token
  bf16 prefill (the MLA attention's share from CUDA events; each MoE
  layer's dropped pairs and largest expert load against its capacity), the
  float32 prefill-against-decode check with the naive and the absorbed MLA
  decode and the two decodes against each other, and the ``ServeEngine``
  with the absorbed decode swapping latent pages; then qwen2-moe at full
  width and depth, a 32,768-token prefill with one K5 launch a layer, all
  on the Hopper kernel (the first and last replayed through the plain
  version, K5 timed at that shape beside SDPA), the same float32 check and
  the engine (every engine but minitron's runs the model's first
  ``ENGINE_LAYERS`` layers, a ``reduced`` line);
* a model over a device mesh (``lm_parallel``, on the qwen2-moe
  parameters that ``lm_moe`` drew): a one-rank NCCL process group and
  ``make_local_mesh``'s (1, 1) mesh, a 4,096-token bf16 prefill through
  the production ``moe_impl="shard_map"`` (the expert-parallel MoE: one K5
  launch and one expert-parallel all-reduce a layer, both counted; the
  first and last K5 launches replayed through the plain version, K5 timed
  at that shape beside SDPA) held to the gspmd prefill of the same tokens
  and timed beside it in turns, the all-reduces' device time;
  ``loss_and_grad`` of a two-layer cut in float32 through both paths,
  every leaf held; the full tree laid out by ``tree_shardings`` under
  FSDP's rule; a two-layer checkpoint saved and ``restore_sharded`` onto
  the mesh, bit for bit;
* the recurrent families (``lm_recurrent``): rwkv6 at full width and
  depth, a 32,768-token bf16 prefill (the chunked WKV, no K5), the float32
  check of prefill against decode at full depth and the ``ServeEngine``
  whose second wave enters used slots; then recurrentgemma at full width
  and depth, a 32,768-token prefill (the RG-LRU scans and the windowed
  attention, whose share comes from CUDA events), a float32 ring-wrap
  check at one pattern of 3 layers (prefill against 2,112 decode steps
  through the 2,048-position ring) and the engine; every admitted slot's
  recurrent rows must read zero and its ring rows empty before its first
  step;
* the frontends (``lm_frontends``): hubert-xlarge at full width and depth
  (48 layers, head dim 80, bidirectional), an encode of 32,768 frame
  embeddings with one K5 launch a layer, all on the Hopper kernel (the
  first and last replayed, K5 timed beside SDPA), and a float32 check at 3
  layers over 1,500 frames (30 s of audio) of the SIMT kernel against the
  plain version; qwen2-vl-2b at full width and depth, a 32,768-token
  prefill with 256 patch embeddings (one K5 launch a layer), the float32
  prefill-against-decode check and the engine;
* the MLA, RWKV6 and RG-LRU layouts (``lm_layout_families``, run inside
  ``lm_moe`` and ``lm_recurrent`` on the models they hold, and timed as a
  phase of its own): deepseek-v2's 4,096-token prefill (MLA, the dense
  layer and the gspmd MoE over the mesh), rwkv6's 32,768-token prefill and
  recurrentgemma's at one pattern of 3 layers through the production layout
  on a one-rank NCCL group and (1, 1) mesh, each held bit for bit to the
  unsharded prefill (logits, hidden states, logits at 256 positions), 8
  decode steps through the layout's cache bit for bit the unsharded ones
  (deepseek-v2's naive and absorbed decodes, recurrentgemma's across the
  wrap of its ring), the collectives as the dry run counts them and its
  predicted peak within 25% of the card's;
* the production layout: minitron-4b's 32,768-token prefill
  (``lm_layout_prefill``, after ``lm_serve``) and qwen2-moe's 4,096-token
  one (inside ``lm_parallel``) through ``parallel.collectives`` over a
  one-rank NCCL group and (1, 1) mesh under ``LOGICAL_RULES`` with
  ``fsdp_rules`` (FSDP's gather, column- and row-parallel products, the
  vocab-parallel embedding and head, the expert-parallel MoE): one K5
  launch a layer on the Hopper kernel, launches 0 and last replayed, the
  hidden states and logits equal to the unsharded prefill's bit for bit;
  after ``lm_train``, ``lm_layout``: ``launch.dryrun.trace_cell`` on a fake
  (1, 1) mesh predicts qwen2-vl-2b's train step (one step run through the
  layout at the end of ``lm_train``) and minitron's prefill, each peak
  within 25% of the card's for the same step, with the counted FLOPs over
  the measured step time;
* training (``lm_train``): qwen2-vl-2b at full width and depth through
  ``make_train_step`` (AdamW, remat "full": K5 forward twice a layer, the
  plain attention's gradient), train_4k's 4,096 tokens at batch 8, six
  steps over the packed pipeline's batches with patch embeddings (the
  step time, tokens/s, peak memory, a replayed K5 launch, the attention
  backward's share); then ``repro_torch.launch.train`` at ``--smoke``
  size, stopped after a checkpoint and resumed, equal to an uninterrupted
  run under deterministic algorithms. The ``examples`` phase also runs
  ``train_small`` and ``packing_pipeline``.

Each phase prints one JSON line, and ``phase_seconds`` each phase's host
wall time; the ``kernels`` line carries each kernel's
launches on its path, its time, its plain version's time, its bound and a
library yardstick; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Exits non-zero, printing no result, without a CUDA device, outside a checkout
of the repository, or when any phase fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
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
INDEX_KEYS = 1 << 24              # the f32 rank plane's limit for one index
INDEX_DATASETS = ("amzn", "face", "osm", "wiki")
INDEX_LOOKUPS = 3                 # timed lookups per dataset
CACHE_SLOTS = 1 << 20             # 16 MiB of 16-byte slots
HOT_KEYS = 1 << 16                # the warm pass's distinct-slot keys
TEAR_KEYS = 64                    # distinct keys of one slot
TEAR_LAUNCHES = 100
ZIPF_THETA = 1.2                  # benchmarks/serve_bench.py's skew
CACHE_REQUESTS = 8
QUEUE_TICKETS = 64
QUEUE_MAX_DELAY_S = 0.002
MERGE_ROUNDS = 16
MERGE_ROUND_OPS = 1024
MERGE_LOOKUPS = 1 << 16
DURABLE_INSERTS = 2048            # through the WAL, DURABLE_RECORD a record
DURABLE_DELETES = 1024            # one delete record every other insert
DURABLE_RECORD = 32
DURABLE_REQUESTS = 4
# single-key fsync'd appends timed on a log of their own: the service's 96
# records are too few for a p99
WAL_TIMED_APPENDS = 4096
# cut from merge_background's 16M: the chain's behaviour does not depend on
# the key count, and the smaller build and merges keep the phase short
CHAOS_KEYS = 2_000_000
CHAOS_REQUESTS = 4
# the observe phase: requests served in each of its four modes, in turns
# (a request's host time varies by a fifth from one to the next, so the
# recorder's budget is held on the median of the turns' paired ratios)
OBSERVE_TURNS = 32
# process-pool workers of the 200M-key builds and the durable merge (one a
# core of the card's host, at most one a shard)
BUILD_WORKERS = min(os.cpu_count() or 1, 24)
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


def exact_ranks(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``np.searchsorted(keys, q, "left")``, searched in the queries'
    sorted order: the same answers, but numpy keeps each answer as the next
    search's lower bound, so ascending queries stay in cache (several times
    faster over 200M keys, where the checks of a run would take minutes)."""
    order = np.argsort(q, kind="stable")
    out = np.empty(q.size, dtype=np.int64)
    out[order] = np.searchsorted(keys, q[order], "left")
    return out


def device_ms(fn, device, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on ``device``: on the card, CUDA events
    around ``reps`` calls, after one warm-up call. The card is first given
    a spin kernel (``torch.cuda._sleep``) twice as long as the host took
    for one call, so every timed launch is queued before the first one
    starts: the events then time the device's work, not the host's launch
    overhead between launches."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second at the H100's clocks; at most a second of spin
    torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 2e9))
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


def chunked(fn, q, *rest, chunk: int = BLOCK):
    """``fn(q, *rest)`` over ``q`` (and the per-query tensors in ``rest``)
    in ``chunk``-sized pieces: the plain versions' count modes build
    [chunk, width] gathers."""
    import torch
    return torch.cat([fn(q[i:i + chunk], *(r[i:i + chunk] for r in rest))
                      for i in range(0, q.numel(), chunk)])


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

def phase_build():
    """Every kernel library, and ``tools/segment_split.cu`` (the split of
    K2's and K3's time) beside them, all compiled at once. Returns the
    split's library."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    from tools import segment_split
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        split_lib = pool.submit(segment_split.build)
        paths = _build.build_all()
        split_lib = split_lib.result()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln
                       or "warning" in ln][:64]
    emit("build", seconds=secs, libraries=sorted(paths), ptxas=ptxas,
         flags=" ".join(_build.NVCC_FLAGS))
    return split_lib


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
    logical = buf.logical_keys()

    def with_want(k: np.ndarray):
        """Device queries, and their ranks over (logical, snapshot) keys."""
        return torch.from_numpy(to_biased(k)).to(device), tuple(
            torch.from_numpy(np.searchsorted(lk, k, "left")).int()
            .to(device) for lk in (logical, keys))
    hot = distinct_slot_keys(keys, CACHE_SLOTS, HOT_KEYS, seed)
    hot = with_want(hot[rng.integers(0, hot.size, n_queries)])
    same = same_slot_keys(keys, CACHE_SLOTS, TEAR_KEYS, seed)
    same = with_want(same[rng.integers(0, same.size, n_queries)])
    results, levels = [], []
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
                    check(match and launches == (device.type == "cuda"),
                          f"kernel variant failed: {row}")
                    row.update(kernel_cache_counters(
                        sp, probe, q, dp, want[0], hot, same, device))
                    results.append(row)
                    emit("kernel", **row)
        levels.append(kernel_levels(sp, kind, q, device))
        del sp
    far = kernel_past_the_end(device, seed, n_queries)
    return dict(variants=len(results),
                max_abs_err=max([r["max_abs_err"] for r in results]
                                + [far["max_abs_err"]]),
                levels=levels, past_the_end=far,
                tear_stress_ok=all(r["tear_stress_ok"] for r in results),
                warm_all_hit=all(r["warm_full_hit"] for r in results))


def same_slot_keys(keys: np.ndarray, n_slots: int, count: int,
                   seed: int) -> np.ndarray:
    """``count`` distinct keys inside ``keys``' range that share one cache
    slot, built by inverting the slot hash: one high word taken from a key,
    the low word solved for each of ``count`` hash values that end in the
    slot's bits (``h ^= h >> 16`` is its own inverse on 32 bits; the
    multiplier 0x9E3779B1 is odd, so it has an inverse mod 2^32). Checked
    against the port's ``cache_slot``."""
    import torch
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.stacked_lookup import cache_slot
    rng = np.random.default_rng(seed)
    target = int(rng.integers(0, n_slots))
    hi = int(keys[keys.size // 2]) >> 32
    inv = pow(0x9E3779B1, -1, 1 << 32)
    out = []
    for t in range(count):
        h = t * n_slots | target
        h ^= h >> 16
        lo = ((h ^ (hi * 0x85EBCA77 & 0xFFFFFFFF)) * inv) & 0xFFFFFFFF
        out.append(hi << 32 | lo)
    out = np.asarray(out, np.uint64)
    slot = cache_slot(torch.from_numpy(to_biased(out)), n_slots)
    check(bool((slot == target).all()) and np.unique(out).size == count
          and out.min() >= keys[0] and out.max() <= keys[-1],
          "same-slot keys: the hash inversion failed")
    return out


def distinct_slot_keys(keys: np.ndarray, n_slots: int, count: int,
                       seed: int) -> np.ndarray:
    """``count`` keys of ``keys`` whose cache slots are pairwise
    distinct."""
    import torch
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.stacked_lookup import cache_slot
    rng = np.random.default_rng(seed)
    pool = keys[rng.integers(0, keys.size, 4 * count)]
    slot = cache_slot(torch.from_numpy(to_biased(pool)), n_slots).numpy()
    _, first = np.unique(slot, return_index=True)
    check(first.size >= count, "too few distinct-slot keys")
    return pool[np.sort(first)[:count]]


def kernel_cache_counters(sp, probe, q, dp, want, hot, same,
                          device) -> dict:
    """One K1 variant with the cache and with the counters, each against
    the plain version on the same inputs: a cold pass from an empty cache
    (ranks equal, exactly), the counted pass (ranks and the counter plane
    equal, exactly), a warm pass over ``hot`` (distinct-slot keys, queried
    twice: the second time every lane hits and the launch is a full hit),
    and the tear stress: ``TEAR_LAUNCHES`` launches over keys of one slot
    (``same``), every rank equal to searchsorted over the logical keys
    (``same[1]``)."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    n = q.numel()

    def fresh_cache():
        return torch.full((2 * CACHE_SLOTS,), -1, dtype=torch.int64,
                          device=device)
    hits = torch.zeros(1, dtype=torch.int32, device=device)
    got = SL.stacked_lookup(sp, probe, q, dp, cache=fresh_cache(), hits=hits)
    plain_hits = torch.zeros(1, dtype=torch.int32, device=device)
    plain = plain_chunked_cached(sp, probe, q, dp, fresh_cache(), plain_hits)
    cold_ok = torch.equal(got[0], want) and torch.equal(plain, want)
    nc = sp.n_shards + SL.N_PROBE_BUCKETS
    counters = torch.zeros(nc, dtype=torch.int64, device=device)
    plain_counters = torch.zeros(nc, dtype=torch.int64, device=device)
    got_c = SL.stacked_lookup(sp, probe, q, dp, counters=counters)
    for i in range(0, n, BLOCK):
        SL.stacked_lookup_plain(sp, probe, q[i:i + BLOCK], dp,
                                counters=plain_counters)
    counted_ok = torch.equal(got_c[0], want) and \
        torch.equal(counters, plain_counters) and int(counters[:sp.n_shards]
                                                      .sum()) == n
    hq, hot_want = hot
    cache = fresh_cache()
    SL.stacked_lookup(sp, probe, hq, dp, cache=cache, hits=hits.zero_())
    got_w = SL.stacked_lookup(sp, probe, hq, dp, cache=cache,
                              hits=hits.zero_())
    warm_hits = int(hits)
    warm_ok = torch.equal(got_w[0], hot_want[0] if dp is not None
                          else hot_want[1])
    sq, same_want = same
    sw = same_want[0] if dp is not None else same_want[1]
    cache = fresh_cache()
    tear_ok = True
    for _ in range(TEAR_LAUNCHES):
        got_t = SL.stacked_lookup(sp, probe, sq, dp, cache=cache,
                                  hits=hits.zero_())
        tear_ok &= torch.equal(got_t[0], sw)
    row = dict(cached_match=cold_ok, plain_cold_hits=int(plain_hits),
               counted_match=counted_ok,
               counters=counters.cpu().tolist(),
               warm_hits=warm_hits, warm_lanes=int(hq.numel()),
               warm_full_hit=warm_hits == hq.numel() and warm_ok,
               tear_stress_ok=tear_ok, tear_launches=TEAR_LAUNCHES)
    check(cold_ok and counted_ok and row["warm_full_hit"] and tear_ok,
          f"K1 with the cache or the counters failed: {row}")
    return row


def plain_chunked_cached(sp, probe, q, delta, cache, hits,
                         chunk: int = BLOCK):
    """The plain version with the cache over ``q`` in ``chunk``-sized
    pieces (in order, as a dispatch's launches)."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    return torch.cat([SL.stacked_lookup_plain(
        sp, probe, q[i:i + chunk], delta, cache=cache, hits=hits)[0]
        for i in range(0, q.numel(), chunk)])


def kernel_past_the_end(device, seed: int, n_queries: int) -> dict:
    """K1 on a narrow radix shard (a 2^26 span above 2^40 beside a wide
    shard below 2^39): keys far past the end (2^64 - 1, 2^63, the last key
    + 2^52) have a radix prefix ``(q - min) >> shift`` of 2^46 and more,
    which the reference's low 32 bits wrap (ROADMAP queue 3, R5). Every
    query, in both spline modes and probe forms, equals the plain version
    and ``np.searchsorted``."""
    import torch
    from repro_torch.core import build_plex
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.planes import build_stacked_planes
    rng = np.random.default_rng(seed + 7)
    half = 1 << 21
    keys = np.concatenate([
        np.sort(rng.integers(0, 1 << 39, half, dtype=np.uint64)),
        np.sort((1 << 40) + rng.integers(0, 1 << 26, half,
                                         dtype=np.uint64))])
    offs = np.asarray([0, half])
    plexes = _forced([build_plex(keys[:half], 64),
                      build_plex(keys[half:], 64)], "radix")
    sp = build_stacked_planes(plexes, offs, device)
    check(sp is not None and sp.kind == "radix", "narrow radix planes")
    shift = int(plexes[1].layer.shift)
    far = np.asarray([U64_MAX, 1 << 63, int(keys[-1]) + (1 << 52)],
                     dtype=np.uint64)
    check(all((int(x) - int(keys[half])) >> shift >= 1 << 31 for x in far),
          "the far keys' radix prefix stays below 2^31")
    q_np = np.concatenate([far, make_queries(keys, n_queries, rng)])
    want = np.searchsorted(keys, q_np, "left")
    q = torch.from_numpy(to_biased(q_np)).to(device)
    err = 0
    for mode in ("count", "bisect"):
        sp.static["mode"] = mode
        for probe in ("count", "bisect"):
            got = SL.stacked_lookup(sp, probe, q, aux=True)
            plain = plain_chunked(sp, probe, q, None)
            err = max(err, max(int((g.long() - w.long()).abs().max())
                               for g, w in zip(got, plain)))
            ranks = got[0].cpu().numpy().astype(np.int64)
            check(err == 0 and np.array_equal(ranks, want),
                  f"K1 past the end of a narrow radix shard ({mode} spline, "
                  f"{probe} probe): {int(np.count_nonzero(ranks != want))} "
                  f"ranks differ from searchsorted, plain error {err}")
    row = dict(keys=int(keys.size), shift=shift, far=[int(x) for x in far],
               queries=int(q_np.size), max_abs_err=err,
               matches_searchsorted=True)
    emit("kernel_past_the_end", **row)
    return row


def kernel_levels(sp, kind: str, q, device) -> dict:
    """K1's summary probe over ``sp`` with the rule's number of levels and
    with the other, in turns (rule, other, other, rule), in both spline
    modes, the other held to the plain version."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    rule = sp.summary.levels
    out = {}
    for mode in ("count", "bisect"):
        sp.static["mode"] = mode
        times: dict = {1: [], 2: []}
        for levels in (rule, 3 - rule, 3 - rule, rule):
            sp.summary = dataclasses.replace(sp.summary, levels=levels)
            if levels != rule:
                got = SL.stacked_lookup(sp, "bisect", q, aux=True)
                want = plain_chunked(sp, "bisect", q, None)
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"{kind} kernel with {levels} summary level(s) "
                      f"differs from its plain version")
            times[levels].append(device_ms(
                lambda: SL.stacked_lookup(sp, "bisect", q), device))
        out[mode] = {str(k): float(np.mean(v)) for k, v in times.items()}
    row = dict(kind=kind, summary_levels=rule,
               summary_bytes=sp.summary.nbytes,
               probe_bytes_per_query=probe_model_bytes(rule),
               ms_by_levels=out)
    emit("kernel_levels", **row)
    return row


# ---------------------------------------------------------------- serve ----

def _kinds(snap) -> dict:
    kinds: dict = {}
    for px in snap.shards:
        k = type(px.layer).__name__
        kinds[k] = kinds.get(k, 0) + 1
    return kinds


class recorded_launches:
    """Within the block, every ``stacked_lookup`` call that serving makes
    is passed through and its arguments kept in ``calls`` (planes, probe,
    queries, delta, overlap, and the keywords as given: the cache, hits or
    counters): the served request's own launches, replayed afterwards for
    device times and for the comparison with the plain version."""

    def __enter__(self):
        from repro_torch.kernels import stacked_lookup as SL
        self.calls, self._orig = [], SL.stacked_lookup

        def record(sp, probe, q, delta=None, **kw):
            self.calls.append((sp, probe, q, delta,
                               kw.get("overlap", False), kw))
            return self._orig(sp, probe, q, delta, **kw)
        SL.stacked_lookup = record
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import stacked_lookup as SL
        SL.stacked_lookup = self._orig


def replay(calls, device) -> dict:
    """The recorded launches again, on the same device tensors: each held
    against the plain version exactly (ranks, shard ids, window bases),
    then both timed with CUDA events, the kernel's launches as served
    (overlap included). Then, in turns, the kernel with every launch made
    without overlap, with the key summary's other number of levels, and
    with the spline searched by bisect where the planes say count.
    Made after the main path's counts were read, so these launches are not
    counted as the main path's."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    err = 0
    for sp, probe, q, delta, *_ in calls:
        # checked one launch at a time: its predecessor on the stream is the
        # plain version, so no overlap
        got = SL.stacked_lookup(sp, probe, q, delta, aux=True)
        want = SL.stacked_lookup_plain(sp, probe, q, delta)
        err = max([err] + [int((g.long() - w.long()).abs().max())
                           for g, w in zip(got, want)])
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"kernel differs from its plain version on a served launch "
              f"of {q.numel()} queries over {sp.n_shards} shard(s)")

    def served(overlap: bool = True):
        return lambda: [SL.stacked_lookup(sp, probe, q, delta,
                                          overlap=overlap and ov)
                        for sp, probe, q, delta, ov, _ in calls]
    out = dict(max_abs_err=err, overlapped=sum(c[4] for c in calls),
               kernel_ms=device_ms(served(), device, reps=3),
               plain_ms=device_ms(lambda: [
                   SL.stacked_lookup_plain(sp, probe, q, delta)
                   for sp, probe, q, delta, *_ in calls], device, reps=1))
    if device.type != "cuda":
        return out
    planes = list({id(c[0]): c[0] for c in calls}.values())
    rule = planes[0].summary.levels
    modes = [sp.static["mode"] for sp in planes]
    times: dict = {"no_overlap": [], rule: [out["kernel_ms"]],
                   3 - rule: [], "spline_bisect": []}
    for levels, overlap, spline in (
            (rule, False, None), (3 - rule, True, None),
            (rule, True, "bisect"), (rule, True, "bisect"),
            (3 - rule, True, None), (rule, False, None),
            (rule, True, None)):
        for sp, mode in zip(planes, modes):
            sp.summary = dataclasses.replace(sp.summary, levels=levels)
            sp.static["mode"] = spline or mode
        ms = device_ms(served(overlap), device, reps=3)
        times["no_overlap" if not overlap else
              "spline_bisect" if spline else levels].append(ms)
    return dict(out, summary_levels=rule,
                summary_bytes=sum(sp.summary.nbytes for sp in planes),
                spline_modes=sorted(set(modes)),
                ms_no_overlap=float(np.mean(times["no_overlap"])),
                ms_spline_bisect=float(np.mean(times["spline_bisect"])),
                ms_by_levels={str(k): float(np.mean(times[k]))
                              for k in (1, 2)})


def bound_bytes(snap, q: np.ndarray) -> int:
    """Bytes one request's launches must move at least: each query's 8 B
    key read and 4 B rank written, and once each over the request every
    distinct 32 B sector holding a key the answer rests on: the data-plane
    key at the query's rank in its shard, and the spline keys (8 B) and
    ranks (4 B) at both ends of its segment. Counted on the host from this
    request's data. Layer cells, shard minima and delta keys are left out,
    so the count errs low."""
    sid = snap.route(q)
    rank = exact_ranks(snap.keys, q)
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


def probe_model_bytes(levels: int) -> int:
    """DRAM bytes a query of the summary probe reads from planes beyond L2
    in the model: one 64-byte data segment, and with two levels one 64-byte
    segment of the 8th-key level before it; the summary's bisect is
    counted as L2 hits. The planes' rows are multiples of 128 keys (and the
    200M-key plane of 64), so no segment straddles a 64-byte boundary."""
    return levels * 64


def probe_levels_on_plane(dk, q_np: np.ndarray, device) -> dict:
    """K4 on one large data plane (the service's 200M keys: 24 shards of
    8.3M in one row) with a one-level and a two-level summary, in turns,
    each held to the plain version and to searchsorted; bases from the
    lower bound minus up to half a window, as the eps guarantee leaves
    them. ``torch.take`` of the key at each answer beside them."""
    import torch
    from repro_torch.kernels import bounded_search as BS
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.planes import build_summary, summary_levels
    window = 256
    n = dk.numel()
    qd = torch.from_numpy(to_biased(q_np)).to(device)
    lb = torch.searchsorted(dk, qd)
    g = torch.Generator(device=device).manual_seed(0)
    off = torch.randint(0, window // 2, lb.shape, generator=g, device=device)
    base = (lb - off).clamp(0, n - window).int()
    ans = lb.clamp(max=n - 1)          # the key at each answer, in the plane
    sm = build_summary(dk, n, 1)
    times: dict = {1: [], 2: []}
    for levels in (1, 2, 2, 1):
        sm = dataclasses.replace(sm, levels=levels)
        got = BS.bounded_search(dk, qd, base, window=window, summary=sm)
        plain = chunked(lambda c, b: BS.bounded_search_plain(
            dk, c, b, window=window, mode="bisect", summary=sm), qd, base)
        check(torch.equal(got, plain) and torch.equal(got.long(), lb),
              f"K4 on the {n}-key plane, {levels} level(s), differs from "
              f"its plain version or from searchsorted")
        times[levels].append(device_ms(lambda: BS.bounded_search(
            dk, qd, base, window=window, summary=sm), device, reps=10))
    out = dict(keys=n, queries=int(q_np.size), window=window,
               summary_bytes=sm.nbytes, rule_levels=summary_levels(n),
               ms_by_levels={str(k): float(np.mean(v))
                             for k, v in times.items()},
               ms_turns={str(k): v for k, v in times.items()},
               probe_bytes_per_query={str(k): 16 + probe_model_bytes(k)
                                      for k in (1, 2)},
               answer_gather_ms=device_ms(lambda: torch.take(dk, ans),
                                          device, reps=10))
    emit("probe_levels", plane="service", **out)
    return out


def cuda_context_pids() -> set | None:
    """Pids ``nvidia-smi`` lists as holding a CUDA context (``None`` when
    it gives no answer)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {int(x) for x in out.split() if x.strip().isdigit()}


def child_pids(pid: int) -> set:
    """Live processes whose parent is ``pid`` (read from ``/proc``)."""
    out = set()
    for p in pathlib.Path("/proc").iterdir():
        if not p.name.isdigit():
            continue
        try:
            stat = (p / "stat").read_text()
        except OSError:
            continue
        # the fields after the parenthesised command: state, ppid, ...
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.add(int(p.name))
    return out


class watch_workers:
    """While the block runs, a thread samples every 0.2 s this
    process's children and the pids ``nvidia-smi`` lists with a CUDA
    context (``children``, ``cuda_pids``; ``cuda_pids`` is ``None`` if
    ``nvidia-smi`` never answered)."""

    def __enter__(self):
        import threading
        self.children, self.cuda_pids, self.samples = set(), None, 0
        self._stop = threading.Event()

        def run():
            while True:
                self.children |= child_pids(os.getpid())
                pids = cuda_context_pids()
                if pids is not None:
                    self.cuda_pids = (self.cuda_pids or set()) | pids
                self.samples += 1
                if self._stop.wait(0.2):
                    return
        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()


def parallel_build_check(device, keys: np.ndarray, snap) -> dict:
    """``keys`` built again by ``Snapshot.build(workers=BUILD_WORKERS)``
    (the start method the rule picks: spawn, since this process holds a
    CUDA context) and held to the serial ``snap``: offsets, every shard's
    spline, layer plane, tuning and persisted statics bit-identical. No
    worker may hold a CUDA context: none of the workers' pids is in
    ``nvidia-smi``'s compute apps while they run (and each task checks its
    own process after its build)."""
    from repro_torch.core import Snapshot
    from repro_torch.core.parallel_build import _mp_context
    from repro_torch.persist.format import _shard_meta
    method = _mp_context().get_start_method()
    with watch_workers() as w:
        t0 = time.perf_counter()
        par = Snapshot.build(keys, snap.eps, n_shards=snap.n_shards,
                             device=device, workers=BUILD_WORKERS)
        par_s = time.perf_counter() - t0
    check(np.array_equal(par.offsets, snap.offsets)
          and par.n_shards == snap.n_shards,
          "parallel build: the shard offsets differ from the serial build")
    for s, (a, b) in enumerate(zip(par.shards, snap.shards)):
        la = a.layer.table if hasattr(a.layer, "table") else a.layer.cells
        lb = b.layer.table if hasattr(b.layer, "table") else b.layer.cells
        check(_shard_meta(a) == _shard_meta(b)
              and np.array_equal(a.spline.keys, b.spline.keys)
              and np.array_equal(a.spline.positions, b.spline.positions)
              and np.array_equal(la, lb),
              f"parallel build: shard {s} differs from the serial build")
    workers = w.children - {os.getpid()}
    listed = w.cuda_pids or set()
    check(workers or snap.n_shards == 1,
          "parallel build: no worker process was seen")
    check(not workers & listed,
          f"parallel build: workers {sorted(workers & listed)} hold a CUDA "
          f"context")
    del par
    out = dict(keys=int(keys.size), shards=snap.n_shards,
               workers=BUILD_WORKERS, cpu_count=os.cpu_count(),
               start_method=method, parallel_build_s=par_s,
               serial_build_s=snap.build_s,
               speedup=snap.build_s / par_s, bit_identical=True,
               worker_pids_seen=len(workers), samples=w.samples,
               cuda_context_pids=None if w.cuda_pids is None
               else sorted(w.cuda_pids),
               parent_listed=os.getpid() in listed,
               workers_with_cuda_context=0)
    emit("parallel_build", **out)
    return out


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
    par_build = parallel_build_check(device, keys, snap)

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
    probe_big = probe_levels_on_plane(dk_sorted, requests[0][1], device)
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
               path="fused" if svc.fused else "per-shard",
               overlapped_launches=sum(r["overlapped"] for r in records),
               parallel_build=par_build)
    if device.type == "cuda":
        out.update(
            summary_levels=records[0]["summary_levels"],
            summary_bytes=records[0]["summary_bytes"],
            probe_bytes_per_query=probe_model_bytes(
                records[0]["summary_levels"]),
            ms_no_overlap=mean("ms_no_overlap"),
            ms_spline_bisect=mean("ms_spline_bisect"),
            spline_modes=sorted({m for r in records
                                 for m in r["spline_modes"]}),
            ms_by_levels={k: float(np.mean([r["ms_by_levels"][k]
                                            for r in records]))
                          for k in ("1", "2")},
            probe_200m=probe_big)
    check_healthy(svc, "serve")
    emit("serve", **out)
    emit("yardstick", library="torch.searchsorted", library_ms=out[
        "library_ms"], queries=n_queries, keys=n_keys)
    emit("serve_profile", path=out["path"],
         top_tottime_ms=profile_request(svc, requests[-1][1]))
    return out, svc


def profile_request(svc, q, top: int = 10) -> list:
    """Where one request's host time goes: ``cProfile`` over one
    ``svc.lookup`` (a service or an index), the functions with the most own
    time (ms). Native calls (numpy, torch) show under their own names."""
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
    want = exact_ranks(logical, q)
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
    check_healthy(svc, "merge")
    return out


# ----------------------------------------------------------- serve_cache ----

def zipf_queries(keys: np.ndarray, n: int, *, theta: float = 1.2,
                 absent_frac: float = 0.1, seed: int = 7) -> np.ndarray:
    """Skewed query stream: Zipf(theta) ranks over the present keys (hot
    ranks mapped to random key positions so skew is independent of key
    order) mixed with ~``absent_frac`` absent keys (midpoints between
    consecutive distinct keys; the fraction is approximate when a midpoint
    collides with a present key). Deterministic given (keys, n, seed). A
    copy of ``benchmarks/serve_bench.py``'s ``zipf_queries``."""
    rng = np.random.default_rng(seed)
    ranks = (rng.zipf(theta, n) - 1) % keys.size
    perm = rng.permutation(keys.size)
    q = keys[perm[ranks]]
    n_abs = int(n * absent_frac)
    if n_abs:
        pos = rng.integers(0, keys.size - 1, n_abs)
        mid = keys[pos] + (keys[pos + 1] - keys[pos]) // np.uint64(2)
        q[rng.permutation(n)[:n_abs]] = mid
    return q


def cache_service(device, seed: int, n_keys: int):
    """A fused ``PlexService`` (eps 64, ``block`` 65,536, ``CACHE_SLOTS``
    slots, ``QUEUE_MAX_DELAY_S``, built over ``BUILD_WORKERS`` processes)
    over ``n_keys`` keys of the first SOSD
    dataset whose shards all unify: ``osm``, then ``wiki``, then ``amzn``
    at halved sizes (a ``reduced`` line for the cut). Returns (dataset,
    keys, service)."""
    import torch
    from repro_torch.data import generate
    from repro_torch.serving import PlexService
    tries = [("osm", n_keys), ("wiki", n_keys)] + [
        ("amzn", n_keys >> k) for k in range(1, 5)]
    for name, n in tries:
        t0 = time.perf_counter()
        keys = generate(name, n, seed)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc = PlexService(keys, eps=64, block=BLOCK, cache_slots=CACHE_SLOTS,
                          max_delay_s=QUEUE_MAX_DELAY_S,
                          build_workers=BUILD_WORKERS, device=device)
        ctor_s = time.perf_counter() - t0
        snap = svc.snapshot
        emit("serve_cache_setup", dataset=name, keys=n, generate_s=gen_s,
             build_s=snap.build_s, planes_upload_s=ctor_s - snap.build_s,
             shards=snap.n_shards, layer_kinds=_kinds(snap),
             path="fused" if svc.fused else "per-shard", block=BLOCK,
             cache_slots=CACHE_SLOTS, build_workers=BUILD_WORKERS)
        if svc.fused:
            if n < n_keys:
                emit("reduced", cache_service_keys=n, of=n_keys,
                     dataset=name, why="no dataset unifies at full size")
            return name, keys, svc
        del svc, snap, keys
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    raise AssertionError("no dataset's shards unified for the cached "
                         "service")


def replay_cached(calls, device) -> dict:
    """One served request's launches again, on the same device tensors
    (after the phase's counts were read): as served with its cache (warm),
    from an emptied cache (cold: the refill of the 16 MiB slot plane
    included), without the cache, as served but with no launch
    overlapping its predecessor, and counted (a counter plane of its
    own)."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    cache = calls[0][5]["cache"]
    sp = calls[0][0]
    hits = torch.zeros(len(calls), dtype=torch.int32, device=device)
    counters = torch.zeros(sp.n_shards + SL.N_PROBE_BUCKETS,
                           dtype=torch.int64, device=device)

    def run(mode: str, overlap=None):
        def fn():
            if mode == "cold":
                cache.fill_(-1)
            for j, (sp_, probe, q, delta, ov, _) in enumerate(calls):
                o = ov if overlap is None else overlap and j > 0
                if mode == "off":
                    SL.stacked_lookup(sp_, probe, q, delta, overlap=o)
                elif mode == "counted":
                    SL.stacked_lookup(sp_, probe, q, delta, overlap=o,
                                      counters=counters)
                else:
                    SL.stacked_lookup(sp_, probe, q, delta, overlap=o,
                                      cache=cache, hits=hits[j:j + 1])
        return fn
    out = {}
    for turn in (("warm", None), ("cold", None), ("off", None),
                 ("counted", None), ("warm_no_overlap", False),
                 ("warm_no_overlap", False), ("counted", None),
                 ("off", None), ("cold", None),
                 ("warm", None)):
        name, ov = turn
        mode = "warm" if name.startswith("warm") else name
        out.setdefault(name, []).append(
            device_ms(run(mode, ov), device, reps=3))
    return {f"ms_{k}": float(np.mean(v)) for k, v in out.items()}


def phase_serve_cache(device, seed: int, n_keys: int, n_queries: int):
    """The cached, counted service on Zipf traffic (``CACHE_REQUESTS``
    requests of ``n_queries``): two with the cache cold then warm, two
    with ``METRICS`` armed (the counted dispatch), two with a live delta,
    and the last two's queries again with the cache detached. Every rank
    against searchsorted over the logical keys, one launch a micro-batch,
    the live hotness against ``np.bincount(route(q))`` and the probe
    histogram against the plain version's counter plane."""
    import torch
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.kernels.keys import to_biased
    from repro_torch.obs.metrics import METRICS
    name, keys, svc = cache_service(device, seed, n_keys)
    st = svc._state.stacked
    rng = np.random.default_rng(seed + 5)
    q_all = zipf_queries(keys, (CACHE_REQUESTS - 2) * n_queries,
                         theta=ZIPF_THETA, seed=seed)
    qs = np.split(q_all, CACHE_REQUESTS - 2)
    svc.warmup()
    # request i: (what it exercises, its queries); the cache-off requests
    # repeat the delta requests' queries
    plan = [("cold", qs[0]), ("warm", qs[1]), ("counted", qs[2]),
            ("counted", qs[3]), ("delta", qs[4]), ("delta", qs[5]),
            ("cache_off", qs[4]), ("cache_off", qs[5])]
    cache = st._cache
    records, calls = [], []
    logical = keys
    # ---- the main path: counts at 0 just before, read just after
    SL.launches = 0
    batches0 = svc.stats.batches
    for i, (what, q) in enumerate(plan):
        METRICS.enabled = what == "counted"
        if i == 4:
            svc.insert(rng.integers(keys[0], keys[-1], 3_000,
                                    dtype=np.uint64))
            svc.delete(keys[rng.integers(0, keys.size, 1_000)])
            check(svc.n_pending > 0 and svc.stats.merges == 0,
                  "serve_cache: the delta must be live")
            logical = svc.logical_keys()
        # the same service with its impl's cache detached
        st._cache = None if what == "cache_off" else cache
        s0 = (svc.stats.cache_queries, svc.stats.cache_hits,
              svc.stats.full_hit_batches, svc.stats.batches, SL.launches)
        with recorded_launches() as rec:
            t0 = time.perf_counter()
            got = svc.lookup(q)
            req_s = time.perf_counter() - t0
        want = exact_ranks(logical, q)
        check(np.array_equal(got, want),
              f"serve_cache {what} request {i}: "
              f"{int(np.count_nonzero(got != want))} of {q.size} ranks "
              f"differ from searchsorted")
        cq, ch, fh, b, ln = (a - a0 for a, a0 in zip(
            (svc.stats.cache_queries, svc.stats.cache_hits,
             svc.stats.full_hit_batches, svc.stats.batches, SL.launches),
            s0))
        records.append(dict(kind=what, index=i, queries=int(q.size),
                            request_ms=req_s * 1e3,
                            lookups_per_s=q.size / req_s,
                            cache_queries=cq, cache_hits=ch,
                            hit_rate=ch / cq if cq else None,
                            full_hit_batches=fh, micro_batches=b,
                            launches=ln))
        calls.append(rec.calls)
    METRICS.enabled = False
    st._cache = cache
    main_launches = SL.launches
    main_batches = svc.stats.batches - batches0
    # ---- end of the main path
    if device.type == "cuda":
        check(0 < main_launches == main_batches,
              f"serve_cache: {main_launches} launches for {main_batches} "
              f"micro-batches")
    for r in records:
        emit("serve_cache_request", **r)
    counted = [q for what, q in plan if what == "counted"]
    hot = np.bincount(svc.route(np.concatenate(counted)),
                      minlength=svc.n_shards)
    check(np.array_equal(svc.live_hotness(), hot),
          "serve_cache: live_hotness() differs from bincount(route(q))")
    plain = torch.zeros(st.planes.n_shards + SL.N_PROBE_BUCKETS,
                        dtype=torch.int64, device=device)
    for q in counted:
        qd = torch.from_numpy(to_biased(q)).to(device)
        for j in range(0, qd.numel(), BLOCK):
            SL.stacked_lookup_plain(st.planes, st.probe, qd[j:j + BLOCK],
                                    counters=plain)
    plain_hist = plain[st.planes.n_shards:].cpu().numpy()
    check(np.array_equal(svc.probe_trip_hist(), plain_hist),
          "serve_cache: the probe histogram differs from the plain "
          "version's")
    # the served launches at the main path's shapes against the plain
    # version (uncached), then the cached request replayed for times
    first = replay(calls[0], device)
    times = replay_cached(calls[1], device)
    request_s = sum(r["request_ms"] for r in records) / 1e3
    cached_recs = [r for r in records if r["cache_queries"]]
    out = dict(dataset=name, keys=int(keys.size), requests=len(records),
               launches=main_launches, micro_batches=main_batches,
               theta=ZIPF_THETA, cache_slots=CACHE_SLOTS,
               lookups_per_s=sum(r["queries"] for r in records) / request_s,
               p99_request_ms=float(np.percentile(
                   [r["request_ms"] for r in records], 99)),
               hit_rate=svc.stats.cache_hit_rate,
               warm_hit_rate=records[1]["hit_rate"],
               full_hit_batches=svc.stats.full_hit_batches,
               cached_requests=len(cached_recs),
               live_hotness_ok=True, probe_hist_ok=True,
               probe_hist=plain_hist.tolist(),
               max_abs_err=first["max_abs_err"],
               plain_ms_first_request=first["plain_ms"],
               kernel_ms_first_request=first["kernel_ms"],
               cached_overlap=all(c[4] for c in calls[1][1:]), **times)
    emit("serve_cache", **out)
    return out, svc, logical


# ----------------------------------------------------------- serve_queue ----

def phase_serve_queue(device, seed: int, svc, logical) -> dict:
    """``QUEUE_TICKETS`` tickets of 1 to 2^16 queries submitted at once to
    the cached service (``max_delay_s`` ``QUEUE_MAX_DELAY_S``), filled with
    no further call: full blocks launch at submit, and the deadline timer
    launches the remainder and drains everything. Each ticket against
    searchsorted; nothing in flight after ``drain()``."""
    from repro_torch.kernels import stacked_lookup as SL
    rng = np.random.default_rng(seed + 6)
    sizes = rng.integers(1, (1 << 16) + 1, QUEUE_TICKETS)
    q_all = zipf_queries(logical, int(sizes.sum()), theta=ZIPF_THETA,
                         seed=seed + 1)
    qs = np.split(q_all, np.cumsum(sizes)[:-1])
    svc.warmup()
    # ---- the main path: counts at 0 just before, read just after
    SL.launches = 0
    b0 = svc.stats.batches
    t_submit, tickets = [], []
    t0 = time.perf_counter()
    for q in qs:
        t_submit.append(time.perf_counter())
        tickets.append(svc.submit(q))
    done = [None] * len(tickets)
    deadline = time.perf_counter() + 10.0
    while not all(done) and time.perf_counter() < deadline:
        now = time.perf_counter()
        for i, t in enumerate(tickets):
            if done[i] is None and t._filled == t.n:
                done[i] = now
        time.sleep(1e-4)
    by_timer = all(d is not None for d in done)
    svc.drain()
    end = max(d for d in done if d is not None) if any(done) else \
        time.perf_counter()
    launches, batches = SL.launches, svc.stats.batches - b0
    # ---- end of the main path
    check(by_timer, "serve_queue: the deadline timer left tickets unfilled")
    for i, (t, q) in enumerate(zip(tickets, qs)):
        got = t.result()
        check(np.array_equal(got, exact_ranks(logical, q)),
              f"serve_queue: ticket {i} of {q.size} differs from "
              f"searchsorted")
    check(svc.stats.inflight_batches == 0,
          f"serve_queue: {svc.stats.inflight_batches} batches in flight "
          f"after drain()")
    if device.type == "cuda":
        check(0 < launches == batches,
              f"serve_queue: {launches} launches for {batches} batches")
    lat = np.asarray([d - s_ for d, s_ in zip(done, t_submit)]) * 1e3
    out = dict(tickets=len(tickets), queries=int(sizes.sum()),
               min_ticket=int(sizes.min()), max_ticket=int(sizes.max()),
               launches=launches, micro_batches=batches,
               filled_by_timer=by_timer,
               ticket_p50_ms=float(np.percentile(lat, 50)),
               ticket_p99_ms=float(np.percentile(lat, 99)),
               lookups_per_s=int(sizes.sum()) / (end - t0),
               inflight_after_drain=svc.stats.inflight_batches,
               matches_searchsorted=True)
    emit("serve_queue", **out)
    return out


# ------------------------------------------------------------- observe ----

OBSERVE_MODES = ("off", "disarmed", "counted", "recorder")
SERVE_SPANS = ("serve.lookup", "serve.staging", "serve.dispatch",
               "serve.sync")


def prometheus_families(text: str) -> dict:
    """The exposition text's families (``# TYPE`` name -> type), every
    sample line checked to parse as ``name[{labels}] value`` and to belong
    to a declared family."""
    fams: dict = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, fam, typ = line.split(" ")
            check(fam not in fams, f"prometheus: duplicate TYPE {fam}")
            fams[fam] = typ
            continue
        metric, value = line.rsplit(" ", 1)
        float(value)
        name = metric.partition("{")[0]
        base = next((name[:-len(s)] for s in ("_bucket", "_sum", "_count")
                     if name.endswith(s) and fams.get(name[:-len(s)])
                     == "histogram"), name)
        check(base in fams, f"prometheus: sample outside a family: {line}")
    return fams


def phase_observe(device, seed: int, svc, logical, n_queries: int) -> dict:
    """Observability on the cached service of ``serve_cache`` (its live
    delta included): ``OBSERVE_TURNS`` requests of ``n_queries`` Zipf
    queries, each served in four modes in a turn (the order rotating from
    turn to turn): obs off; the hooks present
    but disarmed (an SLO watchdog attached, its recorder probe registered,
    the recorder disarmed); ``enable_observability()`` (K1's counted
    variant, full-fidelity spans); ``RECORDER.arm(span_sample=8)`` with
    ``watch_service`` (K1's uncounted, cached variant, sampled spans, the
    sampler thread running). Every rank equals searchsorted; each request
    makes the obs-off request's K1 launches and overlapped launches; the
    counted variant runs only while counting is on; the live hotness grows
    by ``bincount(route(q))`` of the counted requests; the reference's
    budgets hold: the disabled hooks' cost under 2% of the best obs-off
    lookup, the armed recorder within 10% of obs off (the median over the
    turns of the recorder's request time over obs off's in the same turn,
    as the drill holds it: the best of each mode is the tail of a spread
    wider than the budget, and two modes that do the same work differ
    there by 5%), every sampler tick under 10% of its interval; the
    Prometheus text parses and
    ``health()["slo"]`` is present. The serve spans' host times are printed
    beside K1's device time for the same request (its launches replayed as
    served), the first split of a request's host time on the card."""
    import tempfile
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.launch import observe as OBS
    from repro_torch.obs import (METRICS, RECORDER, TRACE,
                                 disable_observability, enable_observability,
                                 watch_service)
    from repro_torch.obs.export import prometheus_text, write_jsonl
    from repro_torch.obs.slo import SLOWatchdog, default_slos
    qs = np.split(zipf_queries(logical, OBSERVE_TURNS * n_queries,
                               theta=ZIPF_THETA, seed=seed + 11),
                  OBSERVE_TURNS)
    wants = [exact_ranks(logical, q) for q in qs]
    svc.warmup()
    TRACE.clear()
    METRICS.reset()
    # the SLO watchdog rides the recorder's sampler (the reference's
    # default objectives, reported, not asserted on the card)
    wd = SLOWatchdog(default_slos())
    hot0 = svc.live_hotness()
    counted_q = []
    rows = {m: [] for m in OBSERVE_MODES}
    served = {}                # mode -> its first request's recorded calls
    spans = {m: [] for m in OBSERVE_MODES}
    tick_frac = 0.0
    # no collector pause inside a timed request, in any mode
    gc.collect()
    gc.disable()
    # ---- the main path: counts at 0 just before, read just after
    SL.launches = 0
    b0 = svc.stats.batches
    for turn, (q, want) in enumerate(zip(qs, wants)):
        # an untimed request first, so every timed mode meets the same warm
        # cache (the counted variant bypasses the cache and warms nothing:
        # by the rotation alone, the mode after it would serve cold)
        check(np.array_equal(svc.lookup(q), want),
              f"observe warm-up turn {turn}: ranks differ from searchsorted")
        # the order rotates each turn, so no mode always goes first
        k = turn % len(OBSERVE_MODES)
        for mode in OBSERVE_MODES[k:] + OBSERVE_MODES[:k]:
            watched = mode in ("disarmed", "recorder")
            if watched:
                watch_service(svc, watchdog=wd)
            if mode == "counted":
                enable_observability()
            elif mode == "recorder":
                RECORDER.arm(interval_s=0.25, span_sample=OBS.SPAN_SAMPLE)
            n_ev = len(TRACE.events())
            l0 = SL.launches
            with recorded_launches() as rec:
                t0 = time.perf_counter()
                got = svc.lookup(q)
                req_s = time.perf_counter() - t0
            launches = SL.launches - l0
            if mode == "recorder":
                RECORDER.tick()
                tick_frac = max(tick_frac,
                                RECORDER.last_tick_s / RECORDER.interval_s)
                check("slo" in svc.health(),
                      "observe: health() has no slo section")
                RECORDER.disarm()
            elif mode == "counted":
                disable_observability()
                counted_q.append(q)
            spans[mode] += TRACE.events()[n_ev:]
            if watched:
                # the probe watch_service registered (the last one)
                RECORDER.remove_probe(RECORDER._probes[-1])
                svc.attach_slo(None)
            check(np.array_equal(got, want),
                  f"observe {mode} turn {turn}: "
                  f"{int(np.count_nonzero(got != want))} ranks differ "
                  f"from searchsorted")
            kw = [c[5] for c in rec.calls]
            if device.type == "cuda":
                check(launches == len(rec.calls),
                      f"observe {mode} turn {turn}: {launches} K1 launches "
                      f"for {len(rec.calls)} calls")
            rows[mode].append(dict(
                request_ms=req_s * 1e3, launches=len(rec.calls),
                overlapped=sum(c[4] for c in rec.calls),
                counted=sum(k.get("counters") is not None for k in kw),
                cached=sum(k.get("cache") is not None for k in kw)))
            served.setdefault(mode, rec.calls)
    main_launches = SL.launches
    main_batches = svc.stats.batches - b0
    # ---- end of the main path
    gc.enable()
    check(not METRICS.enabled and not TRACE.enabled and
          METRICS.counted_dispatch and not RECORDER.armed,
          "observe: observability left armed")
    if device.type == "cuda":
        check(0 < main_launches == main_batches,
              f"observe: {main_launches} K1 launches for {main_batches} "
              f"micro-batches")
    off = rows["off"][0]
    for mode, rs in rows.items():
        for turn, r in enumerate(rs):
            check((r["launches"], r["overlapped"]) ==
                  (off["launches"], off["overlapped"]),
                  f"observe {mode} turn {turn}: {r['launches']} launches, "
                  f"{r['overlapped']} overlapped; obs off made "
                  f"{off['launches']}, {off['overlapped']}")
            want_counted = r["launches"] if mode == "counted" else 0
            check(r["counted"] == want_counted,
                  f"observe {mode} turn {turn}: {r['counted']} counted "
                  f"launches of {r['launches']}")
    hot = np.bincount(svc.route(np.concatenate(counted_q)),
                      minlength=svc.n_shards)
    check(np.array_equal(svc.live_hotness() - hot0, hot),
          "observe: live_hotness() grew by other than bincount(route(q)) "
          "of the counted requests")
    names = {e["name"] for e in spans["counted"]}
    check(set(SERVE_SPANS) <= names,
          f"observe: the counted requests' spans {sorted(names)} miss "
          f"some of {SERVE_SPANS}")
    check(not spans["off"] and not spans["disarmed"],
          "observe: spans recorded with observability off")
    best = {m: min(r["request_ms"] for r in rs) for m, rs in rows.items()}
    lookups_per_s = {m: n_queries / (best[m] / 1e3) for m in best}
    # each mode's request times (ms: min, quartiles, max), printed before
    # the budgets are held to them
    spread = {m: [float(x) for x in np.percentile(
        [r["request_ms"] for r in rs], (0, 25, 50, 75, 100))]
        for m, rs in rows.items()}
    emit("observe_requests", request_ms_min_q1_median_q3_max=spread)
    # the reference's disabled-hook budget: the hook sites' measured cost
    # over a micro-batch against the obs-off time of one lookup
    hook_ns = OBS.measure_disabled_hook_ns()
    ns_off = best["off"] * 1e6 / n_queries
    hook_frac = OBS.HOOKS_PER_LOOKUP * hook_ns / svc.block / ns_off
    # each turn's armed request over the same turn's obs-off request
    paired = [r["request_ms"] / o["request_ms"]
              for r, o in zip(rows["recorder"], rows["off"])]
    recorder_ratio = float(np.median(paired))
    check(hook_frac < OBS.OVERHEAD_BUDGET,
          f"observe: disabled hooks cost {hook_frac:.4%} of a lookup")
    check(recorder_ratio < 1 + OBS.RECORDER_OVERHEAD_BUDGET,
          f"observe: the armed recorder takes {recorder_ratio:.3f}x obs off "
          f"(the median of {len(paired)} turns' paired ratios)")
    check(tick_frac < OBS.TICK_DUTY_BUDGET,
          f"observe: a sampler tick takes {tick_frac:.2%} of its interval")
    fams = prometheus_families(prometheus_text())
    with tempfile.TemporaryDirectory(prefix="plex-observe-") as tmp:
        path = write_jsonl(pathlib.Path(tmp) / "events.jsonl")
        lines = path.read_text().splitlines()
        jsonl_events = len(lines) - 1
        for line in lines:
            json.loads(line)
    # each serve span's host time beside K1's device time for the request
    # (its launches replayed as served: cached, overlapped)
    split = {}
    for mode in ("counted", "recorder"):
        for name in SERVE_SPANS:
            d = [e["dur_us"] / 1e3 for e in spans[mode]
                 if e["name"] == name]
            if d:
                split.setdefault(mode, {})[name] = dict(
                    n=len(d), p50_ms=float(np.percentile(d, 50)),
                    p99_ms=float(np.percentile(d, 99)))
    k1 = replay_cached(served["off"], device)
    # the counted request's launches against the plain version (replay
    # holds each launch to it exactly, then times the uncached kernel)
    exact = replay(served["counted"], device)
    check_healthy(svc, "observe")
    TRACE.clear()
    METRICS.reset()
    out = dict(turns=OBSERVE_TURNS, queries=n_queries, modes=OBSERVE_MODES,
               launches=main_launches, micro_batches=main_batches,
               launches_per_request=off["launches"],
               overlapped_per_request=off["overlapped"],
               counted_launches=sum(r["counted"] for rs in rows.values()
                                    for r in rs),
               uncounted_launches=sum(r["launches"] - r["counted"]
                                      for rs in rows.values() for r in rs),
               best_request_ms=best, lookups_per_s=lookups_per_s,
               request_ms_spread=spread,
               disarmed_over_off=best["disarmed"] / best["off"],
               counted_over_off=best["counted"] / best["off"],
               recorder_over_off=recorder_ratio,
               recorder_over_off_paired_min_median_max=[
                   float(min(paired)), recorder_ratio, float(max(paired))],
               recorder_best_over_off_best=best["recorder"] / best["off"],
               disabled_hook_ns=hook_ns, disabled_hook_frac=hook_frac,
               tick_duty=tick_frac, span_split_host=split,
               k1_device_ms_as_served=k1["ms_warm"],
               k1_device_ms_uncached=exact["kernel_ms"],
               max_abs_err=exact["max_abs_err"],
               slo=wd.status(), jsonl_events=jsonl_events,
               prometheus_families=len(fams), live_hotness_ok=True,
               matches_searchsorted=True)
    emit("observe", **out)
    return out


# --------------------------------------------------------------- routed ----

ROUTED_SLOTS = (1, 2, 4, 8)       # slots on the one card, each count in turn
ROUTED_REQUESTS = 8
ROUTED_PARTIAL_SLOTS = 4
ROUTED_SERVICE_KEYS = 16_000_000  # the service drill merges twice
ROUTED_SERVICE_SHARDS = 8
ROUTED_SERVICE_SLOTS = 4
ROUTED_INSERTS = 2048
ROUTED_DELETES = 1024


def slot_layout(snap, plan) -> list:
    """Each slot of ``plan``: its shard range, its shards' layer kinds and
    whether they unify (the partitioner's gate, read from statics)."""
    from repro_torch.kernels.planes import shards_unify
    rows = []
    for d in range(plan.n_devices):
        lo, hi = plan.shard_range(d)
        kinds: dict = {}
        for px in snap.shards[lo:hi]:
            k = type(px.layer).__name__
            kinds[k] = kinds.get(k, 0) + 1
        rows.append(dict(slot=d, shards=[lo, hi], kinds=kinds,
                         unifies=hi > lo and bool(shards_unify(
                             snap.shards[lo:hi], snap.offsets[lo:hi]))))
    return rows


class slot_timeline:
    """Within the block, every slot's dispatch of ``router`` is bracketed on
    the slot's own stream by two CUDA events (before its first K1 launch,
    after its last), and the K1 launches it made are counted
    (``stacked_lookup.launches`` around it). ``request()`` opens a request
    with an origin event on the current stream; after the request's sync
    ``rows()`` gives (slot, start ms, end ms, launches, micro-batches) of
    each dispatch, times from the origin. The events sit outside the
    launches, so the launches stay adjacent on their stream. On the CPU (no
    stream) the times are 0, and the launches (plain calls there) 0 too."""

    def __init__(self, router):
        self.router, self.events, self.origin = router, [], None
        self.cuda = any(p.stream is not None for p in router.parts)

    def _event(self):
        import torch
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        from repro_torch.kernels import stacked_lookup as SL
        self._impls = []
        for d in self.router.plan.active:
            impl = self.router.parts[int(d)].impl

            def timed(qd, *a, _d=int(d), _o=impl.dispatch, **kw):
                s = self._event()
                l0 = SL.launches
                out = _o(qd, *a, **kw)
                e = self._event()
                self.events.append((_d, s, e, SL.launches - l0, len(out)))
                return out
            impl.dispatch = timed
            self._impls.append(impl)
        return self

    def __exit__(self, *exc):
        for impl in self._impls:
            del impl.dispatch        # the class's method again

    def request(self) -> None:
        self.events = []
        self.origin = self._event()

    def rows(self) -> list:
        if not self.cuda:
            return [(d, 0.0, 0.0, n, mb) for d, _, _, n, mb in self.events]
        return [(d, self.origin.elapsed_time(s), self.origin.elapsed_time(e),
                 n, mb) for d, s, e, n, mb in self.events]


def slot_overlap(rows) -> dict:
    """One request's slot rows -> each slot's K1 time as served (first
    launch's start to last launch's end on its stream), the request's
    device span, and the launches of slots whose busy interval overlaps
    another slot's."""
    overlapped = sum(n for i, (_, s, e, n, _) in enumerate(rows)
                     if any(s < e2 and s2 < e for j, (_, s2, e2, _, _)
                            in enumerate(rows) if j != i))
    return dict(slot_ms={d: e - s for d, s, e, _, _ in rows},
                span_ms=max(e for _, _, e, _, _ in rows)
                - min(s for _, s, _, _, _ in rows),
                overlapped_launches=overlapped,
                launches=sum(n for _, _, _, n, _ in rows))


def routed_slots(device, snap, n_slots: int, per_shard, requests, wants,
                 bound_ms: float) -> dict:
    """The 200M-key snapshot placed over ``n_slots`` slots of the card: the
    plan, which slots unify, and where the partition serves, the requests
    in turns with the per-shard service on the same queries (counts at 0
    just before, read just after)."""
    import torch
    from repro_torch.distrib import plan_placement
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.serving import PlexService
    plan = plan_placement(snap, n_slots)
    layout = slot_layout(snap, plan)
    emit("routed_plan", slots=n_slots, plan=plan.describe().splitlines(),
         layout=layout)
    t0 = time.perf_counter()
    svc = PlexService(None, eps=snap.eps, block=BLOCK, device=device,
                      devices=[device] * n_slots, plan=n_slots,
                      _snapshot=snap)
    rec = dict(slots=n_slots, partitioned=svc.plan is not None,
               unifying_slots=[r["slot"] for r in layout if r["unifies"]],
               setup_s=time.perf_counter() - t0)
    if svc.plan is None:
        check(not all(r["unifies"] for r in layout if r["shards"][1]
                      > r["shards"][0]),
              f"routed: {n_slots} unifying slots did not partition")
        return rec
    router = svc._state.router
    if device.type == "cuda":
        check(len({router.parts[int(d)].stream.cuda_stream
                   for d in plan.active}) == plan.n_active,
              "routed: slots share a stream")
    svc.warmup()
    routed = [int(d) for d in plan.active
              if any(np.any(plan.device_of(q) == d) for q in requests)]
    routed_ms, shard_ms, turns = [], [], []
    per_slot = {d: 0 for d in routed}
    shard_batches = 0
    # ---- the main path: counts at 0 just before, read just after
    SL.launches = SL.plain_calls = 0
    with slot_timeline(router) as tl:
        for i, (q, want) in enumerate(zip(requests, wants)):
            tl.request()
            t0 = time.perf_counter()
            got = svc.lookup(q)
            routed_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, want),
                  f"routed {n_slots} slots request {i}: "
                  f"{int(np.sum(got != want))} ranks differ from "
                  "searchsorted")
            rows = tl.rows()
            for d, _, _, n, mb in rows:
                check(n == mb or not tl.cuda, f"routed slot {d}: {n} K1 "
                      f"launches for {mb} micro-batches")
                per_slot[d] += n if tl.cuda else mb
            turns.append(slot_overlap(rows))
            b0 = per_shard.stats.batches
            t0 = time.perf_counter()
            got = per_shard.lookup(q)
            shard_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, want),
                  f"per-shard request {i} differs from searchsorted")
            shard_batches += per_shard.stats.batches - b0
    launches, plain = SL.launches, SL.plain_calls
    # ---- end of the main path
    check(plain == 0, f"routed: {plain} plain-pipeline calls")
    check(launches == sum(per_slot.values()) + shard_batches
          or device.type != "cuda",
          f"routed: {launches} K1 launches != {sum(per_slot.values())} "
          f"routed + {shard_batches} per-shard micro-batches")
    check(all(per_slot[d] > 0 for d in routed),
          f"routed: a routed slot launched no K1: {per_slot}")
    check_healthy(svc, f"routed ({n_slots} slots)")
    rec["profile_top_tottime_ms"] = profile_request(svc, requests[-1])
    n_q = sum(q.size for q in requests)
    rec.update(
        launches_per_slot={str(d): n for d, n in per_slot.items()},
        launches=sum(per_slot.values()),
        overlapped_launches=sum(t["overlapped_launches"] for t in turns),
        k1_ms_per_slot={str(d): float(np.mean([t["slot_ms"][d]
                                               for t in turns]))
                        for d in routed},
        device_span_ms=float(np.mean([t["span_ms"] for t in turns])),
        bound_ms=bound_ms,
        lookups_per_s=n_q / (sum(routed_ms) / 1e3),
        p99_request_ms=float(np.percentile(routed_ms, 99)),
        request_ms=routed_ms,
        per_shard_lookups_per_s=n_q / (sum(shard_ms) / 1e3),
        per_shard_p99_request_ms=float(np.percentile(shard_ms, 99)),
        per_shard_request_ms=shard_ms, per_shard_launches=shard_batches,
        matches_searchsorted=True)
    svc.close()
    return rec


def routed_service(device, seed: int, n_queries: int) -> dict:
    """The service drill: ``PlexService(devices=[card] * 4, plan=4)`` over
    ``ROUTED_SERVICE_KEYS`` keys of the first SOSD dataset whose 4-slot plan
    partitions (``osm``, ``wiki``, ``amzn``); inserts and deletes through
    the routed merged path, a merge that re-plans, then a merge during
    which ``distrib.partition.load`` fails once for slot 1: the service
    re-plans onto 3 slots and writes a ``device.loss`` incident bundle, the
    ranks stay exact and K1 launches on every surviving slot."""
    import shutil
    import tempfile
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.obs import incident
    from repro_torch.resilience import FAULTS, POINT_PARTITION_LOAD, \
        fail_once
    from repro_torch.serving import PlexService
    emit("reduced", routed_service_keys=ROUTED_SERVICE_KEYS, of=SERVE_KEYS,
         why="the service drill rebuilds its snapshot at two merges")
    rng = np.random.default_rng(seed + 21)
    for name in ("osm", "wiki", "amzn"):
        keys = generate(name, ROUTED_SERVICE_KEYS, seed)
        svc = PlexService(keys, eps=64, block=BLOCK, device=device,
                          n_shards=ROUTED_SERVICE_SHARDS,
                          devices=[device] * ROUTED_SERVICE_SLOTS,
                          plan=ROUTED_SERVICE_SLOTS, merge_threshold=0)
        if svc.plan is not None:
            break
        svc.close()
    check(svc.plan is not None, "routed service: no dataset partitions")
    check(svc.health()["routed_devices"] == ROUTED_SERVICE_SLOTS,
          f"routed service: routed_devices {svc.health()['routed_devices']}")
    svc.warmup()

    def serve(what: str) -> dict:
        logical = svc.logical_keys()
        q = make_queries(logical, n_queries, rng)
        router = svc._state.router
        SL.launches = SL.plain_calls = 0
        with slot_timeline(router) as tl:
            tl.request()
            got = svc.lookup(q)
            rows = tl.rows()
        check(np.array_equal(got, exact_ranks(logical, q)),
              f"routed service ({what}): ranks differ from searchsorted")
        per_slot = {}
        for d, _, _, n, mb in rows:
            per_slot[str(d)] = per_slot.get(str(d), 0) + (n if tl.cuda
                                                          else mb)
        check(SL.plain_calls == 0
              and (SL.launches == sum(per_slot.values()) or not tl.cuda)
              and all(per_slot.get(str(int(d)), 0) > 0
                      for d in router.plan.active
                      if np.any(router.plan.device_of(q) == d)),
              f"routed service ({what}): launches {per_slot}, total "
              f"{SL.launches}, plain {SL.plain_calls}")
        return dict(slots=router.plan.n_devices, launches_per_slot=per_slot,
                    **{k: v for k, v in slot_overlap(rows).items()
                       if k != "slot_ms"})

    out = dict(dataset=name, keys=ROUTED_SERVICE_KEYS,
               shards=svc.n_shards, fresh=serve("fresh"))
    svc.insert(rng.integers(keys[0], keys[-1], ROUTED_INSERTS,
                            dtype=np.uint64))
    svc.delete(keys[rng.integers(0, keys.size, ROUTED_DELETES)])
    out["merged"] = serve("live delta")
    plan0 = svc.plan
    t0 = time.perf_counter()
    check(svc.merge(), "routed service: the merge did not run")
    out["merge_s"] = time.perf_counter() - t0
    check(svc.plan is not plan0
          and svc.plan.n_devices == ROUTED_SERVICE_SLOTS,
          "routed service: the merge did not re-plan")
    out["after_merge"] = serve("after the merge")
    inc_root = pathlib.Path(tempfile.mkdtemp(prefix="plex-routed-inc-"))
    mgr = incident.install(inc_root)
    try:
        svc.insert(rng.integers(keys[0], keys[-1], ROUTED_INSERTS,
                                dtype=np.uint64))
        with FAULTS.injected(POINT_PARTITION_LOAD, fail_once(device=1)):
            check(svc.merge(), "routed service: the second merge did not "
                  "run")
        bundles = [b.name for b in mgr.bundles()]
    finally:
        incident.uninstall()
        FAULTS.reset()
        shutil.rmtree(inc_root, ignore_errors=True)
    h = svc.health()
    check(h["routed_devices"] == ROUTED_SERVICE_SLOTS - 1
          and [b.split("-", 1)[1] for b in bundles] == ["device-loss"],
          f"routed service: after the loss routed_devices "
          f"{h['routed_devices']}, bundles {bundles}")
    check(h["fallback_lookups"] == 0 and h["backend_failures"] == 0
          and all("PartitionLoadError" in e for e in h["last_errors"]),
          f"routed service: unexpected errors {h['last_errors'][:3]}")
    out["after_loss"] = serve("after the device loss")
    out.update(routed_devices_after_loss=h["routed_devices"],
               incident_bundles=bundles, matches_searchsorted=True)
    svc.close()
    return out


def phase_routed(device, seed: int, snap, n_queries: int) -> dict:
    """The routed path: the ``serve`` phase's 200M-key snapshot placed over
    1, 2, 4 and 8 slots of the card (and the fewest slots at which every
    slot unifies, where that is another count), each count that partitions
    serving ``ROUTED_REQUESTS`` requests in turns with the per-shard service
    on the same queries; then the service drill (``routed_service``). The
    partial load runs in the ``durable`` phase, on its generation."""
    import torch
    from repro_torch.distrib import plan_placement
    from repro_torch.serving import PlexService
    rng = np.random.default_rng(seed + 20)
    keys = snap.keys
    requests = [make_queries(keys, n_queries, rng)
                for _ in range(ROUTED_REQUESTS)]
    wants = [exact_ranks(keys, q) for q in requests]
    # K1's bound for a request (the first; the others are alike)
    bound_ms = bound_bytes(snap, requests[0]) / (PEAK_HBM_TBS * 1e12) * 1e3
    first = next((n for n in range(1, snap.n_shards + 1)
                  if all(r["unifies"] for r in slot_layout(
                      snap, plan_placement(snap, n))
                         if r["shards"][1] > r["shards"][0])), None)
    counts = sorted(set(ROUTED_SLOTS) | ({first} if first else set()))
    # the per-shard service over the same snapshot: its shards' planes are
    # the snapshot's cached ones, nothing is rebuilt
    per_shard = PlexService(None, eps=snap.eps, block=BLOCK, device=device,
                            _snapshot=snap)
    per_shard.warmup()
    slots = {}
    for n in counts:
        rec = routed_slots(device, snap, n, per_shard, requests, wants,
                           bound_ms)
        emit("routed_slots", **rec)
        slots[str(n)] = rec
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    check_healthy(per_shard, "routed (per-shard service)")
    served = [r for r in slots.values() if r["partitioned"]]
    check(bool(served), "routed: no slot count partitions the snapshot")
    out = dict(keys=int(keys.size), shards=snap.n_shards,
               layer_kinds=_kinds(snap), first_unifying_slots=first,
               per_shard_path="fused" if per_shard.fused else "per-shard",
               slots=slots,
               service=routed_service(device, seed, n_queries))
    per_shard.close()
    emit("routed", **{k: v for k, v in out.items() if k != "slots"})
    return out


def routed_partial_load(device, gen_dir, logical, n_queries: int,
                        seed: int) -> dict:
    """``plan_from_dir`` and ``open_routed`` over ``ROUTED_PARTIAL_SLOTS``
    slots of the card on a persisted generation: each slot maps strictly
    fewer bytes than one full load, and the routed ranks are exact, with K1
    launching on every slot routed to."""
    from repro_torch.distrib import open_routed, plan_from_dir
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.persist import load_snapshot
    t0 = time.perf_counter()
    full = load_snapshot(gen_dir, device=device).mapped_bytes
    plan = plan_from_dir(gen_dir, ROUTED_PARTIAL_SLOTS)
    router, snaps, mapped = open_routed(
        gen_dir, plan, [device] * ROUTED_PARTIAL_SLOTS, block=BLOCK)
    open_s = time.perf_counter() - t0
    per_slot = [s.mapped_bytes for s in snaps]
    check(all(b < full for b in per_slot),
          f"routed partial load: slots map {per_slot} of {full} bytes")
    q = make_queries(logical, n_queries, np.random.default_rng(seed + 22))
    with slot_timeline(router) as tl:
        tl.request()
        # ---- the main path: counts at 0 just before, read just after
        SL.launches = SL.plain_calls = 0
        out, batch = router.lookup(q)
        launches, plain = SL.launches, SL.plain_calls
        rows = tl.rows()
    check(np.array_equal(out, exact_ranks(logical, q)),
          "routed partial load: ranks differ from searchsorted")
    per = {str(d): n if tl.cuda else mb for d, _, _, n, mb in rows}
    check(plain == 0 and (launches == batch.n_batches or not tl.cuda)
          and len(per) == plan.n_active and all(per.values()),
          f"routed partial load: launches {per}, total {launches}, "
          f"micro-batches {batch.n_batches}, plain {plain}")
    rec = dict(slots=ROUTED_PARTIAL_SLOTS, plan=plan.describe().splitlines(),
               full_mapped_bytes=full, mapped_bytes_per_slot=per_slot,
               mapped_bytes=mapped, open_s=open_s, launches_per_slot=per,
               **{k: v for k, v in slot_overlap(rows).items()
                  if k != "slot_ms"}, matches_searchsorted=True)
    del router, snaps
    return rec


# ------------------------------------------------------ merge_background ----

def phase_merge_background(device, seed: int, n_keys: int) -> dict:
    """A background-merging service over ``n_keys`` ``amzn`` keys
    (threshold 4,096): ``MERGE_ROUNDS`` rounds of ``MERGE_ROUND_OPS``
    inserts and as many deletes, each round followed by a lookup of
    ``MERGE_LOOKUPS`` queries against searchsorted over the logical keys
    of that moment; then at least one merge, and ``close()`` joins the
    worker. Every insert's and delete's latency beside the merges' time."""
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.serving import PlexService
    rng = np.random.default_rng(seed + 8)
    keys = generate("amzn", n_keys, seed)
    svc = PlexService(keys, eps=64, block=BLOCK, cache_slots=CACHE_SLOTS,
                      merge_mode="background", merge_threshold=DELTA_CAP,
                      device=device)
    check(svc.fused, "merge_background: the amzn shards did not unify")
    svc.warmup()
    update_ms = []
    # ---- the main path: counts at 0 just before, read just after
    SL.launches = 0
    b0 = svc.stats.batches
    for r in range(MERGE_ROUNDS):
        logical = svc.logical_keys()
        ins = rng.integers(keys[0], keys[-1], MERGE_ROUND_OPS,
                           dtype=np.uint64)
        dels = logical[rng.integers(0, logical.size, MERGE_ROUND_OPS)]
        for op, k in (("insert", ins), ("delete", dels)):
            t0 = time.perf_counter()
            getattr(svc, op)(k)
            update_ms.append((time.perf_counter() - t0) * 1e3)
        logical = svc.logical_keys()
        q = make_queries(logical, MERGE_LOOKUPS, rng)
        got = svc.lookup(q)
        check(np.array_equal(got, np.searchsorted(logical, q, "left")),
              f"merge_background round {r}: "
              f"{int(np.count_nonzero(got != np.searchsorted(logical, q)))}"
              f" ranks differ from searchsorted")
    t0 = time.perf_counter()
    while svc.stats.merges < 1 and time.perf_counter() - t0 < 120:
        time.sleep(0.01)
    launches, batches = SL.launches, svc.stats.batches - b0
    # ---- end of the main path
    merges = svc.stats.merges
    t0 = time.perf_counter()
    svc.close()
    close_s = time.perf_counter() - t0
    worker = svc._merge_worker
    alive = worker is not None and worker.is_alive()
    check(merges >= 1, "merge_background: no merge published")
    check(not alive, "merge_background: close() left the worker running")
    if device.type == "cuda":
        check(launches >= batches > 0,
              f"merge_background: {launches} launches, {batches} batches")
    logical = svc.logical_keys()
    q = make_queries(logical, MERGE_LOOKUPS, rng)
    check(np.array_equal(svc.lookup(q), np.searchsorted(logical, q, "left")),
          "merge_background: lookups after close() differ")
    out = dict(keys=n_keys, rounds=MERGE_ROUNDS, ops_per_round=2 *
               MERGE_ROUND_OPS, merge_threshold=DELTA_CAP, merges=merges,
               merge_failures=svc.stats.merge_failures,
               merge_s_mean=svc.stats.merge_s / max(svc.stats.merges, 1),
               max_update_ms=max(update_ms),
               p50_update_ms=float(np.percentile(update_ms, 50)),
               launches=launches, micro_batches=batches, close_s=close_s,
               worker_joined=not alive, epoch=svc.epoch,
               matches_searchsorted=True)
    check_healthy(svc, "merge_background")
    emit("merge_background", **out)
    return out


# ------------------------------------------------------------ resilience ----

def check_healthy(svc, phase: str) -> None:
    """Outside the chaos phase a service must show no fallback, no open
    breaker and no error: a chain that quietly served through ``torch`` or
    ``numpy`` would look like a healthy one."""
    h = svc.health()
    bad = {n: b["state"] for n, b in h["breakers"].items()
           if b["state"] != "closed"}
    check(h["fallback_lookups"] == 0 and h["backend_failures"] == 0
          and not bad and not h["last_errors"],
          f"{phase}: fallback {h['fallback_lookups']}, failures "
          f"{h['backend_failures']}, breakers {bad}, errors "
          f"{h['last_errors'][:3]}")


class timed_calls:
    """Within the block, the named attributes (functions or methods) are
    wrapped to add their wall time (after a device sync) to ``seconds``
    under a label: the parts of one real ``PlexService.open``."""

    def __init__(self, device, *targets):
        self.device, self.targets, self.seconds = device, targets, {}

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._orig = []
        for owner, name, label in self.targets:
            orig = getattr(owner, name)
            self._orig.append((owner, name, orig))
            self.seconds[label] = 0.0

            def wrapped(*a, _orig=orig, _label=label, **kw):
                self._sync()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                self._sync()
                self.seconds[_label] += time.perf_counter() - t0
                return out
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._orig):
            setattr(owner, name, orig)


def phase_durable(device, seed: int, svc, keys, n_queries: int,
                  partial=None) -> dict:
    """Restart from disk and serve through K1: the fused, cached service of
    ``serve_cache`` is saved to a directory under ``tempfile`` (fsync on),
    takes ``DURABLE_INSERTS`` inserts and ``DURABLE_DELETES`` deletes through
    the WAL (each append fsync'd and timed; ``WAL_TIMED_APPENDS`` single-key
    appends on a log of their own give the latency's p50 and p99), answers
    ``DURABLE_REQUESTS``
    Zipf requests, and is dropped without ``close`` with a torn record
    appended to its WAL. ``PlexService.open`` then serves the same requests
    through K1 (every rank equal to searchsorted over the logical keys and
    to the live service's answers), a durable merge commits generation 1
    and collects generation 0. ``load_s`` is split into map, biased planes,
    key summary, upload and WAL replay by timing those calls inside the
    open. Where the disk cannot hold two generations of the service, a
    smaller ``osm`` service takes its place (a ``reduced`` line).
    ``partial(gen_dir, logical)``, when given, runs on generation 1 before
    the directory goes (the routed phase's partial load); its record and
    seconds are returned as ``routed_partial`` and ``routed_partial_s``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import LearnedIndex
    from repro_torch.kernels import planes as TPL
    from repro_torch.kernels import segment_lookup as SEG
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.core.parallel_build import _mp_context
    from repro_torch.obs import TRACE
    from repro_torch.obs.metrics import METRICS
    from repro_torch.persist import format as PF
    from repro_torch.persist import (SNAPSHOT_FILE, WriteAheadLog, gen_name,
                                     read_manifest, validate_snapshot,
                                     wal_name)
    from repro_torch.persist.wal import OP_DELETE, OP_INSERT
    from repro_torch.serving import PlexService
    from repro_torch.serving import plex_service as PS
    root = pathlib.Path(tempfile.mkdtemp(prefix="plex-durable-"))
    TRACE.clear()
    TRACE.enable()
    try:
        free = shutil.disk_usage(root).free
        # a generation holds the 8-byte keys and a few percent more
        need = int(2 * 1.1 * 8 * svc.snapshot.n_keys)
        build_s = svc.build_s
        if free < need:
            n = int(free / (2 * 1.1 * 8) * 0.8)
            emit("reduced", durable_keys=n, of=svc.snapshot.n_keys,
                 free_disk_bytes=free, why="the disk cannot hold two "
                 "generations")
            _, keys, svc = cache_service(device, seed, n)
            build_s = svc.build_s
        rng = np.random.default_rng(seed + 9)
        # explicit merges only: the phase's own merge is step 6
        svc.merge_threshold = 0
        t0 = time.perf_counter()
        svc.save(root, fsync=True)
        save_s = time.perf_counter() - t0
        snap_bytes = (root / gen_name(0) / SNAPSHOT_FILE).stat().st_size
        METRICS.reset()
        METRICS.enable()
        METRICS.counted_dispatch = False
        for i in range(DURABLE_INSERTS // DURABLE_RECORD):
            svc.insert(rng.integers(keys[0], keys[-1], DURABLE_RECORD,
                                    dtype=np.uint64))
            if i % 2:
                svc.delete(keys[rng.integers(0, keys.size,
                                             DURABLE_RECORD)])
        appends = METRICS.histogram("wal.append_us").samples()
        METRICS.reset()
        METRICS.enable()
        timing = root / "append-timing.log"
        wal = WriteAheadLog.create(timing, fsync=True)
        for i, k in enumerate(rng.integers(keys[0], keys[-1],
                                           WAL_TIMED_APPENDS,
                                           dtype=np.uint64)):
            wal.append(OP_DELETE if i % 3 == 2 else OP_INSERT, k[None])
        wal.close()
        timing.unlink()
        single = METRICS.histogram("wal.append_us").samples()
        METRICS.disable()
        METRICS.counted_dispatch = True
        METRICS.reset()
        check(svc.n_pending > 0 and svc.generation == 0,
              "durable: the delta must be live in generation 0")
        logical = svc.logical_keys()
        qs = np.split(zipf_queries(logical, DURABLE_REQUESTS * n_queries,
                                   theta=ZIPF_THETA, seed=seed + 3),
                      DURABLE_REQUESTS)
        live = [svc.lookup(q) for q in qs]
        check_healthy(svc, "durable (before the drop)")
        wal_path = root / wal_name(0)
        wal_bytes = wal_path.stat().st_size
        # dropped without close: a torn record (a header and half its
        # payload) lands after the last good one
        with open(wal_path, "ab") as f:
            f.write(b"\x01\x02\x03\x04\x40\x00\x00\x00\x01" + b"\x55" * 32)
        del svc
        gc.collect()
        # ---- the main path: counts at 0 just before, read just after
        SL.launches = 0
        with timed_calls(device,
                         (PS, "load_snapshot", "map"),
                         (PS.PlexService, "__init__", "planes"),
                         (PF, "_host_planes_from_mapped", "biased_planes"),
                         (TPL, "build_summary", "summary"),
                         (WriteAheadLog, "replay", "wal_read")) as tc:
            t0 = time.perf_counter()
            back = PlexService.open(root, block=BLOCK,
                                    cache_slots=CACHE_SLOTS,
                                    max_delay_s=QUEUE_MAX_DELAY_S,
                                    merge_threshold=0, fsync=True,
                                    build_workers=BUILD_WORKERS,
                                    device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            open_s = time.perf_counter() - t0
        check(wal_path.stat().st_size == wal_bytes,
              "durable: the torn WAL tail was not truncated")
        check(np.array_equal(back.logical_keys(), logical),
              "durable: the reopened logical keys differ")
        b0 = back.stats.batches
        records, calls = [], []
        for i, (q, want_live) in enumerate(zip(qs, live)):
            with recorded_launches() as rec:
                t0 = time.perf_counter()
                got = back.lookup(q)
                req_s = time.perf_counter() - t0
            calls.append(rec.calls)
            want = exact_ranks(logical, q)
            check(np.array_equal(got, want) and np.array_equal(got,
                                                               want_live),
                  f"durable request {i}: "
                  f"{int(np.count_nonzero(got != want))} ranks differ from "
                  f"searchsorted, {int(np.count_nonzero(got != want_live))}"
                  " from the live service's")
            records.append(req_s * 1e3)
        launches, batches = SL.launches, back.stats.batches - b0
        # ---- end of the main path
        if device.type == "cuda":
            check(0 < launches == batches,
                  f"durable: {launches} K1 launches for {batches} batches")
        check_healthy(back, "durable (reopened)")
        first = replay(calls[0], device)
        # one shard of the reopened snapshot through the per-index path
        px = back.snapshot.shards[0]
        idx = LearnedIndex(plex=px, device=device)
        qi = px.keys[rng.integers(0, px.keys.size, n_queries)]
        SEG.fused_launches = 0
        got = idx.lookup(qi, backend="cuda")
        index_launches = SEG.fused_launches
        check(np.array_equal(got, np.searchsorted(px.keys, qi, "left")),
              "durable: LearnedIndex on a reopened shard differs from "
              "searchsorted")
        if device.type == "cuda":
            check(index_launches > 0, "durable: no fused K2/K3 + K4 launch "
                  "on the reopened shard")
        del idx
        t0 = time.perf_counter()
        merged = back.merge()
        merge_s = time.perf_counter() - t0
        man = read_manifest(root)
        names = sorted(p.name for p in root.iterdir())
        check(merged and back.generation == 1 and man.generation == 1
              and gen_name(0) not in names and wal_name(0) not in names
              and validate_snapshot(root / gen_name(1)),
              f"durable: after the merge {names}, manifest {man}")
        q = make_queries(back.logical_keys(), n_queries, rng)
        check(np.array_equal(back.lookup(q),
                             exact_ranks(back.logical_keys(), q)),
              "durable: lookups after the merge differ")
        check_healthy(back, "durable (after the merge)")
        routed_partial, partial_s = None, 0.0
        if partial is not None:
            t0 = time.perf_counter()
            routed_partial = partial(root / gen_name(1), back.snapshot.keys)
            partial_s = time.perf_counter() - t0
            emit("routed_partial_load", seconds=partial_s, **routed_partial)
        back.close()
        traced = TRACE.span_names()
        need = ("wal.append", "wal.fsync", "persist.open", "merge.capture",
                "merge.build", "merge.publish", "build.shard")
        check(all(n in traced for n in need),
              f"durable: spans {sorted(traced)} miss some of {need}")
        sec = tc.seconds
        upload_s = sec["planes"] - sec["biased_planes"] - sec["summary"]
        req = np.asarray(records)
        out = dict(keys=int(len(keys)), build_s=build_s, save_s=save_s,
                   snapshot_bytes=snap_bytes, free_disk_bytes=free,
                   load_s=back.load_s, open_s=open_s,
                   load_split=dict(map_s=sec["map"],
                                   biased_planes_s=sec["biased_planes"],
                                   summary_s=sec["summary"],
                                   upload_s=upload_s,
                                   wal_replay_s=back.load_s - sec["map"]
                                   - sec["planes"],
                                   wal_read_s=sec["wal_read"]),
                   build_over_load=build_s / back.load_s,
                   wal_appends=int(single.size),
                   wal_append_p50_us=float(np.percentile(single, 50)),
                   wal_append_p99_us=float(np.percentile(single, 99)),
                   service_wal_appends=int(appends.size),
                   service_wal_append_p50_us=float(
                       np.percentile(appends, 50)),
                   service_wal_append_p99_us=float(
                       np.percentile(appends, 99)),
                   wal_bytes=wal_bytes, torn_tail_truncated=True,
                   first_request_ms=float(req[0]),
                   lookups_per_s=DURABLE_REQUESTS * n_queries
                   / (req.sum() / 1e3),
                   p99_request_ms=float(np.percentile(req, 99)),
                   launches=launches, micro_batches=batches,
                   kernel_ms_first_request=first["kernel_ms"],
                   max_abs_err=first["max_abs_err"],
                   index_launches=index_launches, merge_s=merge_s,
                   merge_build_workers=BUILD_WORKERS,
                   cpu_count=os.cpu_count(),
                   merge_start_method=_mp_context().get_start_method(),
                   traced_spans=sorted(traced),
                   generation=1, generation0_collected=True,
                   routed_partial=routed_partial,
                   routed_partial_s=partial_s,
                   matches_live=True, matches_searchsorted=True,
                   reference_validate="tests/test_torch_persist.py "
                   "(repro.persist.format.validate_snapshot, CPU)")
        emit("durable", **out)
        return out
    finally:
        TRACE.disable()
        TRACE.clear()
        shutil.rmtree(root, ignore_errors=True)


class FakeClock:
    """The breakers' injected clock: time moves only when told."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def phase_chaos(device, seed: int, n_keys: int, n_queries: int) -> dict:
    """The chaos scenarios (``chaos_scenarios``) with tracing on and an
    ``IncidentManager`` installed in a temporary directory: bundles must be
    written for ``breaker.open``, ``backend.unavailable`` (the default
    service that raises), ``generation.quarantine`` (the last-known-good
    ``open``) and ``merge.failure``, each bundle's files must parse, and
    the ``breaker.transition`` events must follow the breaker's states on
    its injected clock (closed -> open, open -> half-open by the clock,
    half-open -> closed or open) and count its opens."""
    import shutil
    import tempfile
    from repro_torch.obs import TRACE, incident
    inc_root = pathlib.Path(tempfile.mkdtemp(prefix="plex-incidents-"))
    mgr = incident.install(inc_root)
    TRACE.clear()
    TRACE.enable()
    try:
        out = chaos_scenarios(device, seed, n_keys, n_queries)
        events = TRACE.events()
        bundles = {}
        for b in mgr.bundles():
            man = json.loads((b / "incident.json").read_text())
            for name in ("health.json", "metrics.json"):
                json.loads((b / name).read_text())
            for line in (b / "spans.jsonl").read_text().splitlines():
                if line:
                    json.loads(line)
            prometheus_families((b / "metrics.prom").read_text())
            bundles.setdefault(man["kind"], []).append(b.name)
    finally:
        TRACE.disable()
        TRACE.clear()
        incident.uninstall()
        shutil.rmtree(inc_root, ignore_errors=True)
    # the default service that raises runs on the card only
    need = ("breaker.open", "generation.quarantine", "merge.failure") + (
        ("backend.unavailable",) if device.type == "cuda" else ())
    check(all(k in bundles for k in need),
          f"chaos: incident bundles {sorted(bundles)}, want {need}")
    trans = [(e["attrs"]["frm"], e["attrs"]["to"]) for e in events
             if e["name"] == "breaker.transition"
             and e["attrs"]["breaker"] == "cuda"]
    path, state = ["closed"], "closed"
    for frm, to in trans:
        if frm != state:
            # open -> half-open happens on the clock, without an event
            check(state == "open" and frm == "half_open",
                  f"chaos: breaker transition {frm} -> {to} from {state}")
            path.append(frm)
        path.append(to)
        state = to
    br = out.pop("breaker")
    check(trans and sum(to == "open" for _, to in trans) == br["opens"]
          and state == br["state"] == "closed"
          and {"closed", "open", "half_open"} <= set(path),
          f"chaos: breaker.transition events {trans} against the breaker "
          f"{br['state']} with {br['opens']} opens")
    out.update(incident_bundles=bundles, breaker_transitions=len(trans),
               breaker_opens=br["opens"], breaker_path=path)
    emit("chaos", **out)
    return out


def chaos_scenarios(device, seed: int, n_keys: int, n_queries: int) -> dict:
    """Degraded, never wrong: a service over ``n_keys`` ``amzn`` keys that
    asked for the fallback chain (``fallback="auto"``; on the card the
    default is none), with ``backend.dispatch`` armed for ``cuda`` by
    ``fail_n(3)``, ``always()`` and ``intermittent(0.3, seed)`` in turn,
    ``CHAOS_REQUESTS`` requests each, then the fault cleared and the
    breaker's cooldown passed on its injected clock. Every rank equals
    searchsorted; the breaker's states (closed -> open -> half-open ->
    closed) and the fallback counts come from ``health()``; the ``torch``
    backend's plain pipeline runs on the card and is timed against K1;
    after ``FAULTS.reset()`` K1 launches resume. On the card a service left
    at its default fallback raises, with no plain call and no fallback,
    when K1's dispatch fails and when its library does not load. Then
    ``persist.snapshot.map`` armed on the newest generation (``open`` serves
    the last known good one) and ``serving.merge.build`` armed on a merge
    (the old state answers bit for bit, the backoff is armed)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.kernels.keys import to_biased
    from repro_torch.persist import gen_name
    from repro_torch.resilience import (FAULTS, MergeFailedError, always,
                                        fail_n, fail_once, intermittent)
    from repro_torch.resilience.faults import (POINT_BACKEND_DISPATCH,
                                               POINT_MERGE_BUILD,
                                               POINT_SNAPSHOT_MAP)
    from repro_torch.serving import PlexService
    rng = np.random.default_rng(seed + 10)
    keys = generate("amzn", n_keys, seed)
    clock = FakeClock()
    svc = PlexService(keys, eps=64, block=BLOCK, merge_threshold=0,
                      fallback="auto", breaker_threshold=3,
                      breaker_cooldown_s=30.0, breaker_clock=clock,
                      merge_backoff_s=5.0, keep_generations=2, device=device)
    check(svc.fused, "chaos: the amzn shards did not unify")
    svc.warmup()
    svc.warmup("torch")
    qs = [make_queries(keys, n_queries, rng) for _ in range(CHAOS_REQUESTS)]
    wants = [np.searchsorted(keys, q, "left") for q in qs]

    def serve(tag):
        for i, (q, want) in enumerate(zip(qs, wants)):
            got = svc.lookup(q)
            check(np.array_equal(got, want),
                  f"chaos {tag} request {i}: "
                  f"{int(np.count_nonzero(got != want))} ranks differ")

    def state():
        return svc.health()["breakers"]["cuda"]["state"]
    SL.launches = 0
    serve("before")
    k1_before = SL.launches
    if device.type == "cuda":
        check(k1_before > 0, "chaos: no K1 launch before the faults")
    scenarios = {"fail_n_3": lambda: fail_n(3, backend="cuda"),
                 "always": lambda: always(backend="cuda"),
                 "intermittent_0.3": lambda: intermittent(0.3, seed,
                                                          backend="cuda")}
    rows = {}
    for name, make in scenarios.items():
        f0, b0 = svc.stats.fallback_lookups, svc.stats.backend_failures
        p0, t0 = SL.plain_calls, FAULTS.trips(POINT_BACKEND_DISPATCH)
        states = [state()]
        with FAULTS.injected(POINT_BACKEND_DISPATCH, make()):
            for i, (q, want) in enumerate(zip(qs, wants)):
                got = svc.lookup(q)
                check(np.array_equal(got, want),
                      f"chaos {name} request {i}: "
                      f"{int(np.count_nonzero(got != want))} ranks differ")
                states.append(state())
            clock.t += 31.0
            states.append(state())
            serve(name + " probe")           # the half-open probe, armed
            states.append(state())
        clock.t += 31.0
        states.append(state())
        serve(name + " cleared")
        states.append(state())
        check(states[-1] == "closed", f"chaos {name}: the breaker did not "
              f"close after the fault was cleared: {states}")
        rows[name] = dict(
            trips=FAULTS.trips(POINT_BACKEND_DISPATCH) - t0,
            fallback_lookups=svc.stats.fallback_lookups - f0,
            backend_failures=svc.stats.backend_failures - b0,
            torch_plain_calls=SL.plain_calls - p0, breaker_states=states)
    seen = {s for r in rows.values() for s in r["breaker_states"]}
    check({"closed", "open", "half_open"} <= seen,
          f"chaos: breaker states seen {sorted(seen)}")
    check(all(r["fallback_lookups"] > 0 for r in rows.values()),
          "chaos: a scenario served no fallback")
    st_torch = svc.snapshot.stacked_impl("torch", block=BLOCK)
    check(st_torch.plain and st_torch.planes.device == svc.device
          and st_torch.planes is svc._state.stacked.planes,
          "chaos: the torch backend does not run on K1's planes on the card")
    FAULTS.reset()
    # ---- K1 after the faults: counts at 0 just before, read just after
    SL.launches = 0
    b0 = svc.stats.batches
    serve("after reset")
    k1_after, batches = SL.launches, svc.stats.batches - b0
    if device.type == "cuda":
        check(0 < k1_after == batches,
              f"chaos: {k1_after} K1 launches after reset for {batches} "
              "micro-batches")
    # the torch backend against K1: one request's dispatch on the card
    qd = torch.from_numpy(to_biased(qs[0])).to(device)
    st = svc._state.stacked
    k1_ms = device_ms(lambda: st.dispatch(qd), device, reps=3)
    torch_ms = device_ms(lambda: st_torch.dispatch(qd), device, reps=1)
    host = {}
    for be in ("cuda", "torch", "cuda", "torch"):
        t0 = time.perf_counter()
        svc.lookup(qs[0], backend=be)
        host.setdefault(be, []).append((time.perf_counter() - t0) * 1e3)
    strict = default_fallback_raises(device, keys, qs[0]) \
        if device.type == "cuda" else None
    # last known good: two generations on disk, the newest unmappable
    root = pathlib.Path(tempfile.mkdtemp(prefix="plex-chaos-"))
    try:
        svc.save(root, fsync=False)
        svc.insert(rng.integers(keys[0], keys[-1], 1_000, dtype=np.uint64))
        check(svc.merge() and svc.generation == 1,
              "chaos: the merge to generation 1 failed")
        logical = svc.logical_keys()
        with FAULTS.injected(POINT_SNAPSHOT_MAP,
                             fail_once(gen_dir=gen_name(1))):
            back = PlexService.open(root, block=BLOCK, fsync=False,
                                    device=device)
        check(back.generation == 0
              and np.array_equal(back.logical_keys(), logical)
              and (root / "quarantine" / gen_name(1)).is_dir(),
              "chaos: open did not serve the last known good generation")
        q = make_queries(logical, n_queries, rng)
        check(np.array_equal(back.lookup(q),
                             np.searchsorted(logical, q, "left")),
              "chaos: the last known good generation answers wrong")
        back.close()
        del back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # a failed merge: the old state answers bit for bit, the backoff armed
    svc.insert(rng.integers(keys[0], keys[-1], 500, dtype=np.uint64))
    state0, before = svc._state, svc.lookup(qs[0])
    with FAULTS.injected(POINT_MERGE_BUILD, fail_once()):
        try:
            svc.merge()
            failed = False
        except MergeFailedError:
            failed = True
    h = svc.health()
    check(failed and svc._state is state0
          and np.array_equal(svc.lookup(qs[0]), before)
          and h["merge_failures"] == 1 and h["merge_retry_in_s"] > 0,
          f"chaos: merge.build: failed={failed}, health {h['merge_failures']}"
          f" failures, retry in {h['merge_retry_in_s']} s")
    svc.close()
    out = dict(keys=n_keys, requests=CHAOS_REQUESTS, queries=n_queries,
               scenarios=rows, k1_launches_before=k1_before,
               k1_launches_after=k1_after, micro_batches_after=batches,
               fallback_lookups=svc.stats.fallback_lookups,
               torch_dispatch_ms=torch_ms, k1_dispatch_ms=k1_ms,
               torch_over_k1=torch_ms / k1_ms,
               host_request_ms={k: float(np.mean(v)) for k, v in
                                host.items()},
               last_known_good=True, merge_build_contained=True,
               merge_retry_in_s=h["merge_retry_in_s"], default_chain=strict,
               breaker=h["breakers"]["cuda"])
    return out


def default_fallback_raises(device, keys, q) -> list:
    """A service over ``keys`` left at its default fallback on the card
    serves nothing in K1's place: with ``backend.dispatch`` failing for
    ``cuda``, and with K1's library failing to load, ``lookup`` raises
    ``BackendUnavailableError``, no plain call runs, no fallback is counted
    and K1 makes no launch; once both are cleared, K1 answers. Returns the
    service's chain."""
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.resilience import (FAULTS, BackendUnavailableError,
                                        always)
    from repro_torch.resilience.faults import POINT_BACKEND_DISPATCH
    from repro_torch.serving import PlexService
    strict = PlexService(keys, eps=64, block=BLOCK, device=device)
    strict.warmup()
    want = np.searchsorted(keys, q, "left")
    p0, l0 = SL.plain_calls, SL.launches
    raised = []

    def no_library(name):
        raise OSError(f"{name}: the kernel library failed to build")
    with FAULTS.injected(POINT_BACKEND_DISPATCH, always(backend="cuda")):
        try:
            strict.lookup(q)
        except BackendUnavailableError:
            raised.append("dispatch")
    load, SL.load_library = SL.load_library, no_library
    try:
        strict.lookup(q)
    except BackendUnavailableError:
        raised.append("library")
    finally:
        SL.load_library = load
    h = strict.health()
    check(raised == ["dispatch", "library"] and SL.plain_calls == p0
          and SL.launches == l0 and h["fallback_lookups"] == 0
          and h["fallback_chain"] == ["cuda"]
          and h["last_errors"][0].startswith("InjectedFault")
          and h["last_errors"][1].startswith("OSError"),
          f"chaos: the default service raised for {raised}, plain calls "
          f"{SL.plain_calls - p0}, K1 launches {SL.launches - l0}, "
          f"health {h['fallback_chain']} {h['fallback_lookups']} "
          f"{h['last_errors'][:2]}")
    check(np.array_equal(strict.lookup(q), want) and SL.launches > l0,
          "chaos: the default service did not serve through K1 after the "
          "faults cleared")
    strict.close()
    return h["fallback_chain"]


# ---------------------------------------------------------------- index ----

# the five example drills (repro_torch.launch) and their arguments on the
# card: none, so each runs at the reference example's defaults
EXAMPLES = (("quickstart", []), ("save_open", []), ("mesh_serve", []),
            ("chaos_drill", []), ("serve_paged", []), ("train_small", []),
            ("packing_pipeline", []))
# the kernel launches each drill must make on the card
EXAMPLE_NEEDS = {"quickstart": "window_probe", "save_open": "stacked_lookup",
                 "mesh_serve": "stacked_lookup",
                 "train_small": "flash_attention"}
# drills whose outputs go under --dir, or checkpoints under --ckpt-dir; the
# packing drill runs on the host, as the reference's, and takes no --device
EXAMPLE_DIR_FLAG = {"save_open": "--dir", "mesh_serve": "--dir",
                    "chaos_drill": "--dir", "train_small": "--ckpt-dir"}
HOST_EXAMPLES = ("packing_pipeline",)


def phase_examples(device, card: str) -> dict:
    """Every ``repro_torch.launch`` example drill through its ``main`` on
    ``device``, as a user runs it (``python -m repro_torch.launch.<name>``),
    its outputs in a temporary directory. Each must return 0 (its own
    assertions: ranks equal searchsorted, the reopened service equal to the
    live one, the incident contract, the swap-in); the launches of K1, the
    fused ``window_probe`` and K5 are counted from 0 around each, and
    quickstart must launch ``window_probe``, save_open and mesh_serve K1."""
    import importlib
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import segment_lookup as SEG
    from repro_torch.kernels import stacked_lookup as SL
    out = {}
    for name, args in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.launch.{name}")
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"plex-{name}-"))
        argv = list(args) + ([] if name in HOST_EXAMPLES
                             else ["--device", str(device)])
        if name in EXAMPLE_DIR_FLAG:
            argv += [EXAMPLE_DIR_FLAG[name], str(tmp)]
        SL.launches = SEG.fused_launches = FA.launches = 0
        t0 = time.perf_counter()
        try:
            rc = mod.main(argv)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        row = {"rc": rc, "seconds": time.perf_counter() - t0,
               "launches": {"stacked_lookup": SL.launches,
                            "window_probe": SEG.fused_launches,
                            "flash_attention": FA.launches},
               "argv": argv}
        out[name] = row
        check(rc == 0, f"examples: {name} returned {rc}")
        need = EXAMPLE_NEEDS.get(name)
        if need is not None and device.type == "cuda":
            check(row["launches"][need] > 0,
                  f"examples: {name} made no {need} launch")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit("examples", card=card, **out)
    return out


def index_bound_bytes(px, q: np.ndarray, kernel: str) -> int:
    """Bytes one 2^20-query launch of ``kernel`` must move at least, from
    this launch's data: K2/K3 read each query's 8 B key and write its 4 B
    base, and read once each distinct 32 B sector of the spline keys (8 B)
    and ranks (4 B) at both ends of the queries' segments; K4 reads each
    query's key and base and writes its index (16 B), and reads once each
    distinct data-plane sector holding an answer; the fused launch reads
    each key and writes each index (12 B) and the sectors of both. Layer
    cells and table entries are left out, so the count errs low."""
    rank_sectors = 32 * np.unique(np.searchsorted(px.keys, q, "left")
                                  // 4).size
    if kernel == "bounded_search":
        return q.size * 16 + rank_sectors
    sk = px.spline.keys
    seg = np.clip(np.searchsorted(sk, q, "right") - 1, 0,
                  max(sk.size - 2, 0))
    ends = np.concatenate([seg, seg + 1])
    spline_sectors = 32 * (np.unique(ends // 4).size
                           + np.unique(ends // 8).size)
    if kernel == "window_probe":
        return q.size * 12 + spline_sectors + rank_sectors
    return q.size * 12 + spline_sectors


def index_times(dp, px, qd, q_np, base, device, split: dict) -> dict:
    """Each kernel of ``dp``'s lookup over the device queries ``qd`` (K2 or
    K3 in the card's form, K4 from ``base``, and the two fused, the main
    path's launch) held against its plain version exactly, then the
    CUDA-event time of one launch, its plain version's, its bound and, for
    K4 and the fused launch, ``torch.searchsorted`` over the data plane.
    K2/K3's times by search form, the fused launch's and the pair's it
    replaces come from ``split`` (``tools/segment_split.py``, in turns).
    The launches made here are not the main path's."""
    import torch
    from repro_torch.kernels import bounded_search as BS
    from repro_torch.kernels import segment_lookup as SEG
    pp = dp.planes
    seg_name = "radix_segment_lookup" if pp.kind == "radix" \
        else "cht_segment_lookup"
    real = pp.dk[:pp.n_real]
    out = {}
    for name, kern, plain, lib in (
            (seg_name, lambda: SEG.window_base(pp, qd),
             lambda: chunked(lambda c: SEG.window_base_plain(pp, c), qd),
             None),
            ("bounded_search",
             lambda: BS.bounded_search(pp.dk, qd, base, window=pp.window,
                                       summary=pp.summary),
             lambda: chunked(lambda c, b: BS.bounded_search_plain(
                 pp.dk, c, b, window=pp.window, mode="bisect",
                 summary=pp.summary), qd, base),
             lambda: torch.searchsorted(real, qd)),
            ("window_probe", lambda: SEG.window_probe(pp, qd),
             lambda: chunked(lambda c: SEG.window_probe_plain(pp, c), qd),
             lambda: torch.searchsorted(real, qd))):
        err = int((kern().long() - plain().long()).abs().max())
        check(err == 0, f"{name} differs from its plain version by {err}")
        out[name] = dict(
            max_abs_err=err, ms=device_ms(kern, device, reps=10),
            plain_ms=device_ms(plain, device, reps=2),
            bound_ms=index_bound_bytes(px, q_np, name)
            / (PEAK_HBM_TBS * 1e12) * 1e3,
            library_ms=device_ms(lib, device, reps=10) if lib else None)
    out[seg_name]["card_form"] = SEG.CARD_FORM
    if split is not None:
        ms = split["ms"]
        out[seg_name].update(
            ms_by_form={m: ms[f"kernel_{m}"] for m in SEG.SEARCH_FORMS},
            split={k: ms[k] for k in SPLIT_PARTS if k in ms})
        out["window_probe"].update(
            pair_ms=ms["pair"],
            ms_by_form={m: ms[f"fused_{m}"] for m in SEG.SEARCH_FORMS})
    out["bounded_search"].update(probe_levels(pp, qd, base, device))
    return out


# the split's parts of K2/K3 (tools/segment_split.py) in the kernels line
SPLIT_PARTS = ("stream", "layer", "layer_count", "layer_bisect",
               "layer_adaptive", "layer_segment", "layer_bisect_x2",
               "layer_warp8", "layer_level0_smem", "whole_adaptive_no_hints",
               "fused_adaptive_no_hints", "torch_take")


def probe_levels(pp, qd, base, device) -> dict:
    """K4 over ``pp`` with its summary's rule and with the other number of
    levels, in turns (rule, other, other, rule), each held to the plain
    version; the summary's bytes and the probe's bytes a query in the
    model beside them, and the time of ``torch.take`` of one key at each
    answer (one random 8-byte read a query: what the byte bound counts,
    at the card's rate for scattered reads)."""
    import torch
    from repro_torch.kernels import bounded_search as BS
    rule = pp.summary.levels
    times: dict = {1: [], 2: []}
    for levels in (rule, 3 - rule, 3 - rule, rule):
        sm = dataclasses.replace(pp.summary, levels=levels)
        if levels != rule:
            got = BS.bounded_search(pp.dk, qd, base, window=pp.window,
                                    summary=sm)
            plain = chunked(lambda c, b: BS.bounded_search_plain(
                pp.dk, c, b, window=pp.window, mode="bisect", summary=sm),
                qd, base)
            check(torch.equal(got, plain), f"K4 with {levels} summary "
                  f"level(s) differs from its plain version")
        times[levels].append(device_ms(lambda: BS.bounded_search(
            pp.dk, qd, base, window=pp.window, summary=sm), device,
            reps=10))
    ans = BS.bounded_search(pp.dk, qd, base, window=pp.window,
                            summary=pp.summary).long().clamp(
                                max=pp.dk.numel() - 1)
    return dict(summary_levels=rule, summary_bytes=pp.summary.nbytes,
                probe_bytes_per_query=16 + probe_model_bytes(rule),
                ms_by_levels={str(k): float(np.mean(v))
                              for k, v in times.items()},
                answer_gather_ms=device_ms(lambda: torch.take(pp.dk, ans),
                                           device, reps=10))


def mean_of(rows):
    """The mean over ``rows`` of each number (nested dicts too); strings,
    flags, ``None`` and integers equal in every row are taken as they
    are."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: mean_of([r[k] for r in rows]) for k in first
                if all(k in r for r in rows)}
    if first is None or isinstance(first, (str, bool)) or (
            isinstance(first, int) and all(r == first for r in rows)):
        return first
    return float(np.mean(rows))


def phase_index(device, seed: int, n_keys: int, n_queries: int,
                split_lib=None) -> dict:
    """The per-index path on each dataset: ``LearnedIndex.lookup`` (one
    launch a call: K2 or K3 fused with K4) against searchsorted, the host
    ``backend="numpy"`` beside it, K2/K3's split
    (``tools/segment_split.py``, on the card) and each kernel timed on the
    dataset's own launch; then the variant matrix."""
    import torch
    from repro_torch.core import LearnedIndex
    from repro_torch.data import generate
    from repro_torch.kernels import bounded_search as BS
    from repro_torch.kernels import segment_lookup as SEG
    from repro_torch.kernels.keys import to_biased
    from tools.segment_split import split as segment_split
    if n_keys < INDEX_KEYS:
        emit("reduced", index_keys=n_keys, of=INDEX_KEYS)
    rng = np.random.default_rng(seed + 3)
    cuda = device.type == "cuda"
    names = {"radix": "radix_segment_lookup", "cht": "cht_segment_lookup",
             "probe": "bounded_search", "fused": "window_probe"}
    launches = dict.fromkeys(names.values(), 0)
    timed: dict = {n: [] for n in names.values()}
    matrix_px = None
    for ds in INDEX_DATASETS:
        keys = generate(ds, n_keys, seed)
        t0 = time.perf_counter()
        idx = LearnedIndex.build(keys, 64, device=device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.warmup()                       # planes upload, one lookup
        warm_s = time.perf_counter() - t0
        dp = idx.backend_impl()
        kind = dp.planes.kind
        q = make_queries(keys, n_queries, rng)
        want = np.searchsorted(keys, q, "left")
        # ---- the main path: counts at 0 just before, read just after
        SEG.launches = BS.launches = SEG.fused_launches = 0
        secs = []
        for i in range(INDEX_LOOKUPS):
            t0 = time.perf_counter()
            got = idx.lookup(q)
            secs.append(time.perf_counter() - t0)
            check(np.array_equal(got, want),
                  f"{ds} lookup {i}: "
                  f"{int(np.count_nonzero(got != want))} ranks differ "
                  f"from searchsorted")
        seg_n, probe_n, fused_n = SEG.launches, BS.launches, \
            SEG.fused_launches
        # ---- end of the main path
        if cuda:
            check((seg_n, probe_n, fused_n) == (0, 0, INDEX_LOOKUPS),
                  f"{ds}: {fused_n} fused, {seg_n} segment and {probe_n} "
                  f"probe launches for {INDEX_LOOKUPS} lookups (want one "
                  f"fused launch a lookup)")
        launches[names[kind]] += seg_n
        launches[names["probe"]] += probe_n
        launches[names["fused"]] += fused_n
        t0 = time.perf_counter()
        host = idx.lookup(q, backend="numpy")
        host_s = time.perf_counter() - t0
        check(np.array_equal(host, want),
              f"{ds}: backend='numpy' differs from searchsorted on "
              f"{int(np.count_nonzero(host != want))} queries")
        qd = torch.from_numpy(to_biased(q)).to(device)
        split = None
        if split_lib is not None:
            split = segment_split(split_lib, dp.planes, qd, device)
            emit("segment_split", dataset=ds, index="tuned", **split)
        base = SEG.window_base(dp.planes, qd)
        times = index_times(dp, idx.plex, qd, q, base, device, split)
        for name, t in times.items():
            timed[name].append(t)
        emit("index", dataset=ds, keys=n_keys, queries=int(q.size),
             layer=kind, spline_mode=dp.planes.static["mode"],
             card_form=SEG.CARD_FORM, probe="bisect",
             window=dp.planes.window, n_spline=dp.planes.sk.numel(),
             search_width=SEG.search_width(dp.planes), build_s=build_s,
             warmup_s=warm_s, fused_launches=fused_n,
             segment_launches=seg_n, probe_launches=probe_n,
             lookups=INDEX_LOOKUPS,
             lookups_per_s=INDEX_LOOKUPS * q.size / sum(secs),
             lookup_ms=[s_ * 1e3 for s_ in secs],
             numpy_lookups_per_s=q.size / host_s,
             matches_searchsorted=True, kernels=times)
        if ds == "amzn":
            matrix_px = (idx.plex, q)
            emit("index_profile", dataset=ds,
                 top_tottime_ms=profile_request(idx, q))
        del idx, dp, qd, base
    if cuda:
        check(launches["window_probe"] > 0,
              "the fused K2/K3 + K4 kernel made no launch on the per-index "
              "path")
    matrix = phase_index_matrix(device, *matrix_px, split_lib)
    out = {}
    for name, rows in timed.items():
        if not rows:
            continue
        # times: the mean over the datasets this kernel served
        out[name] = mean_of(rows)
        out[name].update(launches=launches[name], max_abs_err=max(
            [r["max_abs_err"] for r in rows] + [matrix["max_abs_err"][name]]))
        if name in matrix["forced_split"]:
            out[name]["forced_layer"] = matrix["forced_split"][name]
    emit("index_summary", kernels=out)
    return out


def phase_index_matrix(device, px, q_np, split_lib=None) -> dict:
    """Both layers forced on one dataset, crossed with the three spline
    search forms and both probe forms: each kernel's output equals its
    plain version's on the card (window bases for K2/K3, indices for K4 and
    for K2/K3 fused with K4), and the ranks equal searchsorted; K2/K3's
    split on each forced layer."""
    import torch
    from repro_torch.kernels import bounded_search as BS
    from repro_torch.kernels import segment_lookup as SEG
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.ops import DevicePlex
    from repro_torch.kernels.planes import finalize_indices
    from tools.segment_split import split as segment_split
    qd = torch.from_numpy(to_biased(q_np)).to(device)
    want = np.searchsorted(px.keys, q_np, "left")
    err = {"radix_segment_lookup": 0, "cht_segment_lookup": 0,
           "bounded_search": 0, "window_probe": 0}
    forced_split = {}
    cases = 0
    for kind in ("radix", "cht"):
        fpx = _forced([px], kind)[0]
        dp = DevicePlex.from_plex(fpx, device=device)
        pp = dp.planes
        check(pp.kind == kind, f"forced {kind} layer")
        seg_name = f"{kind}_segment_lookup"
        if split_lib is not None:
            split = segment_split(split_lib, pp, qd, device)
            emit("segment_split", dataset="amzn", index=f"forced_{kind}",
                 **split)
            forced_split[seg_name] = dict(
                search_width=split["search_width"],
                ms_by_form={m: split["ms"][f"kernel_{m}"]
                            for m in SEG.SEARCH_FORMS},
                split={k: split["ms"][k] for k in SPLIT_PARTS
                       if k in split["ms"]})
        base_plain = chunked(lambda c: SEG.window_base_plain(pp, c), qd)
        probe_plain = chunked(lambda c: SEG.window_probe_plain(pp, c), qd)
        for mode in SEG.SEARCH_FORMS:
            base = SEG.window_base(pp, qd, mode)
            e = int((base.long() - base_plain.long()).abs().max())
            err[seg_name] = max(err[seg_name], e)
            fused = SEG.window_probe(pp, qd, mode)
            fe = int((fused.long() - probe_plain.long()).abs().max())
            err["window_probe"] = max(err["window_probe"], fe)
            fused_ranks = finalize_indices(fused, q_np.size, pp.n_real)
            seg_ms = device_ms(lambda: SEG.window_base(pp, qd, mode), device)
            for probe in ("count", "bisect"):
                got = BS.bounded_search(pp.dk, qd, base, window=pp.window,
                                        mode=probe, summary=pp.summary)
                plain = chunked(lambda c, b: BS.bounded_search_plain(
                    pp.dk, c, b, window=pp.window, mode=probe,
                    summary=pp.summary), qd, base)
                pe = int((got.long() - plain.long()).abs().max())
                err["bounded_search"] = max(err["bounded_search"], pe)
                ranks = finalize_indices(got, q_np.size, pp.n_real)
                row = dict(layer=kind, spline_mode=mode, probe=probe,
                           window=pp.window, search=SEG.search_width(pp),
                           segment_max_abs_err=e, probe_max_abs_err=pe,
                           fused_max_abs_err=fe,
                           matches_searchsorted=bool(
                               np.array_equal(ranks, want)
                               and np.array_equal(fused_ranks, want)),
                           segment_ms=seg_ms,
                           probe_ms=device_ms(lambda: BS.bounded_search(
                               pp.dk, qd, base, window=pp.window,
                               mode=probe, summary=pp.summary), device))
                emit("index_matrix", **row)
                cases += 1
                check(e == 0 and pe == 0 and fe == 0
                      and row["matches_searchsorted"],
                      f"index variant failed: {row}")
        del dp, pp
    return dict(cases=cases, max_abs_err=err, forced_split=forced_split)


# ------------------------------------------------------------ attention ----

ATTN_SHAPES = ((2, 256, 4, 2, 64), (1, 512, 8, 8, 32), (2, 256, 4, 1, 128),
               (1, 128, 2, 2, 16))      # test_pallas_flash_sweep's shapes
# bf16 cases the sweep misses, (b, s, h, kvh, d, causal): D 96 at group 3,
# ragged against the 128-key tile; minitron-4b's grouping at S 4,096; a
# ragged non-causal case at D 16 and at D 32
ATTN_BF16_CASES = ((1, 1000, 6, 2, 96, True), (1, 4096, 24, 8, 128, True),
                   (1, 4096, 24, 8, 128, False), (1, 1000, 4, 2, 16, False),
                   (2, 333, 4, 1, 32, False))
# hubert-xlarge's head dim, 80 (five 16-column panels on the Hopper kernel,
# five 16-column loads a key row on the SIMT one), in both dtypes, causal
# and not: its 16 heads at 1,500 frames (30 s of audio at 50 frames/s,
# ragged against both kernels' key tiles) and a GQA case at a ragged 333
ATTN_D80_SHAPES = ((1, 1500, 16, 16, 80), (2, 333, 4, 2, 80))
# hubert's heads beside SDPA, non-causal as its encoder attends
ATTN_HUBERT_TIMING = (1, 4096, 16, 16, 80)
ATTN_TIMING_SEQ = 4096                  # bf16 kernel beside SDPA, each D
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # the reference's tolerances
LM_ARCH = "minitron-4b"
LM_PREFILL_SEQ = 32768                  # prefill_32k's length
LM_CHECK_TOKENS = 64                    # prefill against decode, float32
LM_EXACT_ROWS = 4096                    # each launch's rows held to f64
# a bf16 kernel's max and mean error against the exact float64 function may
# be at most these factors of its plain version's (at the kernel's tile):
# one bf16 output step doubles a max error; two plain tiles' means differ
# by under 2% on the attention cases
EXACT_MAX_FACTOR = 2.0
EXACT_MEAN_FACTOR = 1.05
LM_SERVE_BATCH = 4
LM_SERVE_MAX_SEQ = 512
# the H100's dense bf16 tensor-core peak (NVIDIA's data sheet, at 700 W):
# K5's bound is its flops over this
PEAK_BF16_TFLOPS = 989.0


def attention_err(got, want, dtype: str) -> tuple[float, bool]:
    """Max abs difference and whether every element is within the
    reference's tolerance (rtol = atol = ``ATTN_TOL[dtype]``)."""
    import torch
    g, w = got.float(), want.float()
    tol = ATTN_TOL[dtype]
    return (float((g - w).abs().max()),
            bool(torch.allclose(g, w, rtol=tol, atol=tol)))


def attention_flops(b: int, sq: int, skv: int, h: int, d: int,
                    causal: bool) -> int:
    """Flops of one K5 launch: two products of 2*D for each (row, key)
    pair it keeps; causal keeps row i's keys j <= i."""
    kept = min(sq, skv)
    pairs = (kept * (kept + 1) // 2 + (sq - kept) * skv if causal
             else sq * skv)
    return 4 * b * h * d * pairs


def attention_bound_ms(q, k, causal: bool) -> tuple[float, str]:
    """The least time of one launch on these inputs: its flops over the
    bf16 peak, against q, k, v and o read or written once over the HBM
    rate. Returns the larger and what bounds it."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    flop_ms = (attention_flops(b, sq, skv, h, d, causal)
               / (PEAK_BF16_TFLOPS * 1e12) * 1e3)
    io = q.element_size() * b * d * (2 * sq * h + 2 * skv * kvh)
    byte_ms = io / (PEAK_HBM_TBS * 1e12) * 1e3
    return ((flop_ms, "operations") if flop_ms >= byte_ms
            else (byte_ms, "bytes"))


def outside_tol(got, want, dtype: str) -> int:
    """How many elements of ``got`` lie outside the reference's tolerance of
    ``want`` (rtol = atol = ``ATTN_TOL[dtype]``)."""
    tol = ATTN_TOL[dtype]
    g, w = got.float(), want.float()
    return int(((g - w).abs() > tol + tol * w.abs()).sum())


def exact_attention_f64(q, k, v, causal: bool):
    """``softmax(q.k^T * D^-0.5) v`` in float64, with no key blocks and no
    rounding of p: the function every K5 version approximates, for
    [B, S, H, D] q against [B, S, KVH, D] k and v, one kv head at a time."""
    import torch
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    out = torch.empty((b, sq, h, d), dtype=torch.float64, device=q.device)
    keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
    for bi in range(b):
        for j in range(kvh):
            qj = q[bi, :, j * g:(j + 1) * g].double().permute(1, 0, 2)
            s = qj @ k[bi, :, j].double().T * d ** -0.5
            if causal:
                s = s.masked_fill(~keep, float("-inf"))
            out[bi, :, j * g:(j + 1) * g] = (
                torch.softmax(s, dim=-1) @ v[bi, :, j].double()).permute(
                    1, 0, 2)
    return out


def exact_errors(q, k, v, causal: bool, **outs) -> dict:
    """Max and mean abs error against ``exact_attention_f64`` of each named
    ``[B, S, H, D]`` output of the function on q, k and v."""
    exact = exact_attention_f64(q, k, v, causal)
    errs = {}
    for name, t in outs.items():
        e = (t.double() - exact).abs()
        errs[name] = (e.max().item(), e.mean().item())
    return errs


def check_exact(errs: dict, what: str, against: str = "plain") -> None:
    """Every output in ``errs`` but ``against`` is within
    ``EXACT_MAX_FACTOR`` (max) and ``EXACT_MEAN_FACTOR`` (mean) of
    ``against``'s error against the exact function."""
    ref_max, ref_mean = errs[against]
    for name, (e_max, e_mean) in errs.items():
        check(e_max <= EXACT_MAX_FACTOR * ref_max
              and e_mean <= EXACT_MEAN_FACTOR * ref_mean,
              f"{what}: {name} is further from the exact function than "
              f"{against}: {errs}")


def plain_tensor_core_scores(q, k, v, *, causal: bool = True,
                             scale: float | None = None,
                             block_k: int = 128):
    """``flash_attention_plain``'s function and blocks with q.k^T as bf16
    products summed in float32 on the tensor cores
    (``bmm(..., out_dtype=float32)``, the Pallas kernel's ``jnp.dot(...,
    preferred_element_type=float32)``), which is how the Hopper kernel's
    wgmma rounds; bfloat16 CUDA tensors only. The prefill's near-one-hot
    rows put some p within a score rounding of a bf16 step, so the
    prefill's launches are replayed through this at the kernel's tile, and
    it is held to the exact function as closely as the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    q3 = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4).reshape(
        b * kvh, g * sq, d)
    k3 = k.permute(0, 2, 1, 3).reshape(b * kvh, skv, d)
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((b, kvh, g, sq), FA.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, skv, block_k):
        n = min(block_k, skv - k0)
        # causal: only rows r0.. see this block (``flash_attention_plain``)
        r0 = min(k0, sq) if causal else 0
        if r0 == sq:
            break
        qr = q3 if r0 == 0 else q3.view(b * kvh, g, sq, d)[:, :, r0:] \
            .reshape(b * kvh, g * (sq - r0), d)
        s = torch.bmm(qr, k3[:, k0:k0 + n].transpose(1, 2).contiguous(),
                      out_dtype=torch.float32).view(
                          b, kvh, g, sq - r0, n) * scale
        if causal:
            kpos = torch.arange(k0, k0 + n, device=q.device)
            s = torch.where(qpos[r0:] >= kpos[None, :], s, FA.NEG_INF)
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l[..., r0:] = l[..., r0:] * corr + p.sum(dim=-1)
        m[..., r0:] = m_new
        pv = torch.matmul(p.to(v.dtype).float(),
                          vt[:, :, None, k0:k0 + n].float())
        acc[..., r0:, :] = acc[..., r0:, :] * corr[..., None] + pv
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def phase_attention(device, seed: int,
                    timing_seq: int = ATTN_TIMING_SEQ) -> dict:
    """K5 against its plain version at the kernel's own key tile, on the
    card: the four shapes of ``test_pallas_flash_sweep``, causal and not,
    float32 (SIMT kernel) and bfloat16 (Hopper kernel), then
    ``ATTN_BF16_CASES``; one launch a case; each bf16 case also held to the
    exact function (``check_exact``). Then each bf16 head dim timed
    at ``timing_seq`` (24/8 heads, causal) beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(seed)

    def qkv(b, s, h, kvh, d, dt):
        return [torch.randn(shape, generator=gen, device=device).to(dt)
                for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]
    cases = [(*shape, causal, dtype) for shape in ATTN_SHAPES
             + ATTN_D80_SHAPES
             for causal in (True, False)
             for dtype in ("float32", "bfloat16")]
    cases += [(*case, "bfloat16") for case in ATTN_BF16_CASES]
    worst = 0.0
    for b, s, h, kvh, d, causal, dtype in cases:
        dt = getattr(torch, dtype)
        q, k, v = qkv(b, s, h, kvh, d, dt)
        before = FA.launches
        got = FA.flash_attention_fwd(q, k, v, causal=causal)
        launched = FA.launches - before
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # a fault shows here
        block_k = FA.kernel_block_k(dt, d)
        plain = FA.flash_attention_plain(q, k, v, causal=causal,
                                         block_k=block_k)
        err, ok = attention_err(got, plain, dtype)
        row = dict(b=b, s=s, h=h, kvh=kvh, d=d, causal=causal, dtype=dtype,
                   kernel=FA.KERNELS[dt], block_k=block_k,
                   launches=launched, max_abs_err=err, tol=ATTN_TOL[dtype],
                   within_tol=ok)
        if dt == torch.bfloat16:
            row["exact_f64_max_mean_err"] = exact_errors(
                q, k, v, causal, kernel=got, plain=plain)
        emit("attention", **row)
        check(ok and launched == (device.type == "cuda"),
              f"K5 case failed: {row}")
        if dt == torch.bfloat16:
            check_exact(row["exact_f64_max_mean_err"], f"K5 case {row}")
        worst = max(worst, err)
    timing = []
    _, _, hh, hkv, hd = ATTN_HUBERT_TIMING
    for b, s, h, kvh, d, causal in [
            (1, timing_seq, 24, 8, d, True) for d in FA.SUPPORTED_HEAD_DIMS
    ] + [(1, timing_seq, hh, hkv, hd, False)]:
        q, k, v = qkv(b, s, h, kvh, d, torch.bfloat16)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = device_ms(lambda: FA.flash_attention_fwd(q, k, v,
                                                      causal=causal), device)
        row = dict(d=d, b=b, s=s, h=h, kvh=kvh, causal=causal,
                   dtype="bfloat16", kernel_ms=ms,
                   library_ms=device_ms(
                       lambda: F.scaled_dot_product_attention(
                           qs, ks, vs, is_causal=causal, enable_gqa=True),
                       device),
                   bound_ms=attention_bound_ms(q, k, causal)[0],
                   kernel_tflops=attention_flops(
                       b, s, s, h, d, causal) / (ms * 1e9))
        emit("attention_timing", **row)
        timing.append(row)
    return dict(cases=len(cases), max_abs_err=worst, timing=timing)


class recorded_attention:
    """Within the block, every K5 call the model makes is passed through;
    ``dtypes`` gets each call's q dtype (which picks the kernel), and the
    inputs and output of the calls numbered in ``keep`` (default: all) are
    kept in ``calls`` as (number, q, k, v, kwargs, out), references and no
    copies, to be replayed through the plain version afterwards."""

    def __init__(self, keep=None):
        self.keep = keep

    def __enter__(self):
        from repro_torch.layers import attention as A
        self.calls, self.dtypes, self._orig = [], [], A.flash_attention_fwd

        def record(q, k, v, **kw):
            out = self._orig(q, k, v, **kw)
            i = len(self.dtypes)
            self.dtypes.append(q.dtype)
            if self.keep is None or i in self.keep:
                self.calls.append((i, q, k, v, kw, out))
            return out
        A.flash_attention_fwd = record
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention as A
        A.flash_attention_fwd = self._orig


def timed(fn, device) -> tuple[object, float]:
    """``fn()`` and its seconds on the host clock, synchronised."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def replay_k5_launch(call, phase: str) -> dict:
    """One recorded K5 launch replayed in full through the plain version at
    the kernel's key tile. The gate is the tolerance against the replay
    that rounds scores as the kernel does (bf16 on the card: tensor-core
    scores); the float32-score plain version's distance is reported. The
    first rows of the kernel and both replays are held to the exact
    function in float64. Emits the row as ``phase`` and returns it."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    i, q, k, v, kw, got = call
    dtype = str(q.dtype).split(".")[1]
    tensor_core = q.dtype == torch.bfloat16 and q.device.type == "cuda"
    block_k = FA.kernel_block_k(q.dtype, q.shape[-1])
    plain = FA.flash_attention_plain(q, k, v, block_k=block_k, **kw)
    replay = (plain_tensor_core_scores(q, k, v, block_k=block_k, **kw)
              if tensor_core else plain)
    err, ok = attention_err(got, replay, dtype)
    plain_err, _ = attention_err(got, plain, dtype)
    causal = kw.get("causal", True)
    rows = min(LM_EXACT_ROWS, q.shape[1])
    keys = rows if causal else k.shape[1]
    outs = dict(kernel=got[:, :rows], plain=plain[:, :rows])
    if tensor_core:
        outs["tensor_core_plain"] = replay[:, :rows]
    row = dict(launch=i, block_k=block_k, max_abs_err=err,
               tol=ATTN_TOL[dtype], within_tol=ok,
               replay="tensor-core scores" if tensor_core else "plain",
               plain_max_abs_err=plain_err,
               plain_outside_tol=outside_tol(got, plain, dtype),
               exact_f64_rows=rows,
               exact_f64_max_mean_err=exact_errors(
                   q[:, :rows], k[:, :keys], v[:, :keys], causal, **outs))
    emit(phase, **row)
    check(ok, f"K5 launch {i} differs from its replay by {err} "
              f"(tolerance {ATTN_TOL[dtype]})")
    if q.dtype == torch.bfloat16:
        check_exact(row["exact_f64_max_mean_err"], f"K5 launch {i}")
    return row


def replay_summary(replays: list) -> dict:
    """The worst of a prefill's replayed launches."""
    return dict(max_abs_err=max(r["max_abs_err"] for r in replays),
                tol=replays[0]["tol"], block_k=replays[0]["block_k"],
                replay=replays[0]["replay"],
                plain_max_abs_err=max(r["plain_max_abs_err"]
                                      for r in replays),
                plain_outside_tol=sum(r["plain_outside_tol"]
                                      for r in replays))


def k5_times(q, k, v, kw, device) -> dict:
    """K5 on one launch's inputs beside its plain version (at the kernel's
    key tile), SDPA and its bound, each timed on the card."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    b, sq, h, d = q.shape
    causal = kw.get("causal", True)
    bound_ms, bound_by = attention_bound_ms(q, k, causal)
    flops = attention_flops(b, sq, k.shape[1], h, d, causal)
    ms = device_ms(lambda: FA.flash_attention_fwd(q, k, v, **kw), device,
                   reps=3)
    plain_ms = device_ms(lambda: FA.flash_attention_plain(
        q, k, v, block_k=FA.kernel_block_k(q.dtype, d), **kw), device,
        reps=1)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True), device, reps=3)
    return dict(shape=[b, sq, h, k.shape[2], d], kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library=f"F.scaled_dot_product_attention(is_causal="
                        f"{causal}, enable_gqa=True)",
                bound_ms=bound_ms, bound_by=bound_by,
                kernel_tflops=flops / (ms * 1e9))


def phase_lm_prefill(device, seed: int, seq: int, cfg=None) -> tuple:
    """minitron-4b at full width, random weights from ``seed``: a batched
    prefill of ``seq`` tokens through ``make_prefill_step`` whose K5 launches
    are each replayed (bf16: within the tolerance of the plain version with
    tensor-core scores; the float32-score plain version's distance
    reported; both and the kernel held to float64 on the first rows); K5
    timed at that shape
    beside its plain version, its bound and SDPA; the same prefill again,
    unrecorded, as the main path (one K5 launch a layer, counted; its time
    to first token and peak memory); then the float32 check of prefill
    against token-by-token decode.
    Returns the phase's record and (model, params) for the serve phase."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import Model
    from repro_torch.models.steps import make_prefill_step
    cfg = cfg or get_config(LM_ARCH)
    shape = SHAPES["prefill_32k"]
    emit("reduced", lm_arch=cfg.name, lm_prefill_batch=1,
         of=shape.global_batch, why="prefill_32k's global batch of 32 cut "
         "to one sequence on one card")
    model = Model(cfg)
    params, init_s = timed(lambda: model.init(seed, device=device), device)
    n_params = sum(t.numel() for t in _leaves(params))
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    _, warm_s = timed(lambda: prefill(params, {"tokens": tokens[:, :256]}),
                      device)
    # an untimed prefill keeps every launch's q, k, v and output (about
    # 17 GB at S = 32,768) to replay each through the plain version
    with recorded_attention() as rec:
        rec_logits, rec_s = timed(lambda: prefill(params,
                                                  {"tokens": tokens}),
                                  device)
    check(len(rec.calls) == cfg.n_layers,
          f"{len(rec.calls)} attention calls for {cfg.n_layers} layers")
    qdt = rec.calls[0][1].dtype            # the dtype that picks the kernel
    kernel = FA.KERNELS[qdt]
    replays = [replay_k5_launch(call, "lm_prefill_replay")
               for call in rec.calls]
    _, q, k, v, kw, _ = rec.calls[-1]
    del rec
    times = k5_times(q, k, v, kw, device)
    # the float32 SIMT kernel at the same shape: the earlier design's time
    q, k, v = (t.float() for t in (q, k, v))
    simt_f32_ms = device_ms(lambda: FA.flash_attention_fwd(q, k, v, **kw),
                            device, reps=1)
    del q, k, v
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    # ---- the main path, nothing recorded: K5's count at 0 just before,
    # read just after; its time and peak memory are the prefill's
    FA.launches = 0
    logits, prefill_s = timed(lambda: prefill(params, {"tokens": tokens}),
                              device)
    launches = FA.launches
    # ---- end of the main path
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    check(tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    if device.type == "cuda":
        check(launches == cfg.n_layers,
              f"K5 launched {launches} times in a prefill of "
              f"{cfg.n_layers} layers")
    out = dict(arch=cfg.name, params=n_params, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, init_s=init_s, seq=seq, batch=1,
               warmup_s=warm_s, recorded_prefill_s=rec_s,
               ttft_s=prefill_s,
               prefill_tokens_per_s=seq / prefill_s, launches=launches,
               kernel=kernel, launches_expected=cfg.n_layers,
               replayed_launches=[r["launch"] for r in replays],
               **replay_summary(replays), **times,
               simt_f32_ms=simt_f32_ms,
               kernel_share_of_prefill=(launches * times["kernel_ms"]
                                        / (prefill_s * 1e3)),
               max_memory_allocated=peak,
               logits_equal_recorded=bool(torch.equal(logits, rec_logits)))
    emit("lm_prefill", **out)
    out["check"], _ = lm_prefill_check(device, dataclasses.replace(
        cfg, dtype="float32"), params, tokens[:, :LM_CHECK_TOKENS])
    return out, model, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def logit_agreement(want, got, tol: float = 1e-3) -> dict:
    """Two [S, V] float32 logit tables: the same greedy argmax in every
    row, and every logit within ``tol`` of its row's largest |logit| (the
    first rows that miss are listed)."""
    import torch
    scale = want.abs().amax(dim=-1)
    rel = ((want - got).abs().amax(dim=-1) / scale)
    same = want.argmax(-1) == got.argmax(-1)
    out = dict(tokens=want.shape[0], argmax_equal=bool(same.all()),
               max_rel_err=float(rel.max()), tol=tol,
               max_abs_logit=float(scale.max()))
    if not same.all() or float(rel.max()) > tol:
        rows = torch.nonzero(~same | (rel > tol)).flatten().tolist()[:4]
        out["misses"] = [dict(
            pos=r, rel_err=float(rel[r]),
            want_top2=[float(x) for x in want[r].topk(2).values],
            got_top2=[float(x) for x in got[r].topk(2).values])
            for r in rows]
    return out


def lm_prefill_check(device, cfg32, params, tokens,
                     phase: str = "lm_prefill_check") -> tuple:
    """float32 (TF32 off): logits of every position from the batched
    forward against ``serve_step`` run token by token (the decode path):
    the same greedy argmax, and every logit within 1e-3 of its row's
    largest |logit|. Returns the record (emitted as ``phase``) and the
    decode logits [S, V]."""
    import torch
    from repro_torch.models import Model, init_cache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m32 = Model(cfg32)
    n = tokens.shape[1]
    x, _ = m32.forward(params, {"tokens": tokens})
    full = m32.logits(params, x)[0].float()
    cache = init_cache(cfg32, 1, n, device=device)
    dec = []
    for t in range(n):
        lg, cache = m32.serve_step(params, cache, tokens[:, t:t + 1], t)
        dec.append(lg[0].float())
    dec = torch.stack(dec)
    out = dict(dtype="float32", tf32=False, **logit_agreement(full, dec))
    emit(phase, **out)
    check(out["argmax_equal"] and out["max_rel_err"] <= 1e-3,
          f"prefill and decode disagree: {out}")
    return out, dec


def phase_lm_serve(device, seed: int, model, params,
                   prompt: int = 64, max_new: int = 32) -> dict:
    """The port's ``ServeEngine`` at full width over the model's first
    ``ENGINE_LAYERS`` layers: batch 4, max_seq 512, 8 requests of
    ``prompt`` tokens and ``max_new`` new ones, and two of other lengths
    (one short, queued fourth, one long, queued last), so slots retire at
    different steps, later requests are admitted beside sequences in
    flight and the position groups split. Every request must finish, the
    page table must map its pages, and ``kv_store.fetch`` must return the
    swapped KV exactly. Then ``profile_serve_step`` of the whole model."""
    from repro_torch.models import Model
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed + 5)
    vocab = model.cfg.vocab
    whole = model
    if model.cfg.n_layers > ENGINE_LAYERS:
        emit("reduced", lm_arch=model.cfg.name, engine_layers=ENGINE_LAYERS,
             of=model.cfg.n_layers, why="the engine's checks (position "
             "groups that split, admissions beside sequences in flight, "
             "swapped KV fetched exactly) hold at every depth, and its "
             "host-bound steps cost about the same a layer; the decode step "
             "of the whole model is profiled after it")
        model = Model(dataclasses.replace(model.cfg, n_layers=ENGINE_LAYERS))
    lengths = [(prompt, max_new)] * 3 + [(prompt // 4, max_new // 4)] + \
        [(prompt, max_new)] * 5 + [(prompt * 5 // 8, max_new * 3 // 2)]
    eng = ServeEngine(model, params, batch_size=LM_SERVE_BATCH,
                      max_seq=LM_SERVE_MAX_SEQ, device=device)
    stored: dict = {}
    store = eng.kv_store.store

    def keep(seq_id, kv):
        stored[seq_id] = kv.copy()
        return store(seq_id, kv)
    eng.kv_store.store = keep
    calls = {"steps": 0, "sub_batches": 0}
    step = model.serve_step

    def count(params_, cache, tokens, pos):
        calls["steps"] += 1
        calls["sub_batches"] += tokens.shape[0] < LM_SERVE_BATCH
        return step(params_, cache, tokens, pos)
    model.serve_step = count
    for i, (n, m) in enumerate(lengths):
        eng.submit(Request(seq_id=i, prompt=rng.integers(0, vocab, n).astype(
            np.int32), max_new=m))
    done_at: dict = {}
    t0 = time.perf_counter()
    try:
        while any(eng.slots) or eng.queue:
            eng.step()
            now = time.perf_counter() - t0
            for f in eng.finished:
                done_at.setdefault(f.seq_id, now)
    finally:
        del model.serve_step
    run_s = time.perf_counter() - t0
    fin = {f.seq_id: f for f in eng.finished}
    check(sorted(fin) == list(range(len(lengths))),
          f"finished {sorted(fin)} of {len(lengths)} requests")
    for sid, (n, m) in enumerate(lengths):
        toks = fin[sid].tokens
        check(toks.size == m and bool(((toks >= 0) & (toks < vocab)).all()),
              f"request {sid}: {toks.size} tokens of {m}")
        kv = eng.kv_store.fetch(sid, stored[sid].shape[0])
        check(np.array_equal(kv, stored[sid]),
              f"request {sid}: fetched KV differs from the swapped KV")
    pages = sum(f.swapped_pages for f in fin.values())
    check(len(eng.kv_store.table) == pages, "page table misses pages")
    check(calls["sub_batches"] > 0, "no position group split")
    lat = [done_at[s] * 1e3 for s in range(len(lengths))]
    emit("lm_serve_profile", **profile_serve_step(device, whole, params))
    generated = sum(m for _, m in lengths)
    out = dict(requests=len(lengths), batch=LM_SERVE_BATCH,
               max_seq=LM_SERVE_MAX_SEQ, n_layers=model.cfg.n_layers,
               engine_steps=eng.steps,
               serve_step_calls=calls["steps"],
               sub_batch_calls=calls["sub_batches"], run_s=run_s,
               generated_tokens=generated,
               decode_tokens_per_s=generated / run_s,
               positions_per_s=sum(n + m for n, m in lengths) / run_s,
               request_latency_ms=lat, p50_latency_ms=float(np.median(lat)),
               max_latency_ms=max(lat), pages=pages,
               page_table_rebuilds=eng.kv_store.table.rebuilds,
               page_lookups=eng.kv_store.table.lookups,
               fetch_exact=True)
    emit("lm_serve", **out)
    return out


def profile_serve_step(device, model, params) -> dict:
    """Where one full-batch ``serve_step`` spends its time: the host clock
    around it, the device's kernel time inside it from ``torch.profiler``
    (its busy share of the call), and ``cProfile``'s functions with the
    most own time (ms)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import init_cache
    cache = init_cache(model.cfg, LM_SERVE_BATCH, LM_SERVE_MAX_SEQ,
                       device=device)
    tokens = torch.zeros((LM_SERVE_BATCH, 1), dtype=torch.int32,
                         device=device)

    def call():
        return model.serve_step(params, cache, tokens, 8)[0].float().cpu()
    call()
    _, call_s = timed(call, device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        _, prof_s = timed(call, device)
    dev_us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages())
    pr = cProfile.Profile()
    pr.enable()
    call()
    pr.disable()
    rows = sorted(pstats.Stats(pr).stats.items(),
                  key=lambda kv: -kv[1][2])[:10]
    return dict(call_ms=call_s * 1e3, profiled_call_ms=prof_s * 1e3,
                device_kernel_ms=dev_us / 1e3,
                device_busy_share=(dev_us / 1e3) / (prof_s * 1e3),
                top_tottime_ms=[[f"{pathlib.Path(f).name}:{line}:{fn}",
                                 tt * 1e3]
                                for (f, line, fn), (_, _, tt, _, _) in rows])


# ------------------------------------------------------------ the MoE ----

MOE_DEEPSEEK = "deepseek-v2-236b"
MOE_QWEN = "qwen2-moe-a2.7b"
DEEPSEEK_LAYERS = 3            # the dense layer 0 and two MoE layers
DEEPSEEK_PREFILL_SEQ = 4096    # the plain MLA attention's scores, below
ALIGNED_REQUESTS = 8
ENGINE_LAYERS = 3              # serve_aligned's depth: one layer pattern
# what the qwen2-moe prefill of 32,768 tokens needs beside its weights:
# the MoE dispatch (about 3 GB), two recorded K5 launches and their
# replays, SDPA's copies and the allocator's slack
MOE_PREFILL_WORKSPACE = 12 << 30


class recorded_routing:
    """Within the block, every ``layers.moe.route`` call is passed through
    and its routing kept in ``routings`` (references to device tensors, no
    sync), one a MoE layer in layer order."""

    def __enter__(self):
        from repro_torch.layers import moe as M
        self.routings, self._orig = [], M.route

        def record(p, x, cfg):
            r = self._orig(p, x, cfg)
            self.routings.append(r)
            return r
        M.route = record
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe as M
        M.route = self._orig


class evented_calls:
    """Within the block, every call of ``layers.<layer>.<name>`` (default
    the plain ``flash_attention``: MLA's, or the windowed prefill of
    ``layers.attention.apply_gqa``; or RWKV's ``_wkv_chunked``; a dotted
    ``layer`` names a module of ``repro_torch`` itself) is bracketed by
    CUDA events (host clock on the CPU); ``ms()`` gives a span's time after
    a sync."""

    def __init__(self, device, layer: str, name: str = "flash_attention"):
        self.device, self.layer, self.name = device, layer, name

    def _module(self):
        import importlib
        if "." in self.layer:
            return importlib.import_module(f"repro_torch.{self.layer}")
        return importlib.import_module(f"repro_torch.layers.{self.layer}")

    def __enter__(self):
        import torch
        M = self._module()
        self.spans, self._orig = [], getattr(M, self.name)
        cuda = self.device.type == "cuda"

        def mark():
            if not cuda:
                return time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def timed_call(*a, **kw):
            t0 = mark()
            out = self._orig(*a, **kw)
            self.spans.append((t0, mark()))
            return out
        self.mark = mark
        setattr(M, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self._module(), self.name, self._orig)

    def ms(self, a, b) -> float:
        if self.device.type != "cuda":
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def routing_stats(cfg, routings) -> list:
    """Each MoE layer's routing of a call: its dropped (token, slot) pairs
    and its largest expert load against the capacity."""
    layers = [i for i in range(cfg.n_layers) if cfg.layer_kind(i)[1] == "moe"]
    check(len(routings) == len(layers),
          f"{len(routings)} routings for {len(layers)} MoE layers")
    rows = []
    for i, r in zip(layers, routings):
        load = r.idx.reshape(-1).bincount(minlength=cfg.n_experts)
        rows.append(dict(layer=i, tokens=r.idx.shape[0], cap=r.cap,
                         dropped=int((~r.keep).sum()),
                         max_load=int(load.max()),
                         mean_load=r.idx.numel() / cfg.n_experts))
    return rows


def share_of_prefill(device, prefill, params, tokens, layer: str,
                     calls: int, name: str = "flash_attention",
                     key: str = "attention") -> dict:
    """A prefill with CUDA events around every call of
    ``layers.<layer>.<name>`` (``evented_calls``) and around the whole call:
    those calls' device time (``<key>_ms``) and their share."""
    with evented_calls(device, layer, name) as tc:
        t0 = tc.mark()
        prefill(params, {"tokens": tokens})
        t1 = tc.mark()
        whole = tc.ms(t0, t1)
        part = sum(tc.ms(a, b) for a, b in tc.spans)
    check(len(tc.spans) == calls,
          f"{len(tc.spans)} calls of {layer}.{name}, {calls} expected")
    return {f"{key}_ms": part, "evented_prefill_ms": whole,
            f"{key}_share": part / whole}


def prefill_main_path(device, cfg, prefill, params, tokens,
                      batch=None, keep: dict | None = None) -> dict:
    """The main path of one model: a bf16 prefill through
    ``make_prefill_step`` of ``{"tokens": tokens}`` (or ``batch``: frames,
    patch embeddings), K5's count set to 0 just before and read just
    after; the kernel each launch took (by q's dtype), time to first token,
    peak memory and each MoE layer's routing (none for a model without
    MoE layers). ``keep["logits"]`` takes the prefill's logits."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    batch = batch if batch is not None else {"tokens": tokens}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with recorded_attention(keep=()) as att, recorded_routing() as rr:
        FA.launches = 0
        logits, ttft_s = timed(lambda: prefill(params, batch), device)
        launches = FA.launches
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    check(tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name}: prefill logits not finite or misshapen")
    if keep is not None:
        keep["logits"] = logits
    seq = next(iter(batch.values())).shape[1]
    return dict(seq=seq, batch=1, ttft_s=ttft_s,
                prefill_tokens_per_s=seq / ttft_s, k5_launches=launches,
                k5_calls=len(att.dtypes),
                k5_kernels=sorted({FA.KERNELS[dt] for dt in att.dtypes}),
                max_memory_allocated=peak,
                routing=routing_stats(cfg, rr.routings))


def checked_admissions(eng) -> dict:
    """Wraps ``eng._admit``: after every admission, each slot it filled
    must hold a fresh sequence's state before its first step (its
    recurrent rows zero, its ring rows ``EMPTY_POS``; R12, R13). Returns
    the counts, filled as the engine runs."""
    from repro_torch.models.lm import EMPTY_POS
    from repro_torch.serving.engine import POSITIONAL, RING, cache_leaves
    counts = {"admitted": 0, "into_used_slots": 0, "state_rows": 0,
              "ring_rows": 0}
    used: set = set()
    admit = eng._admit

    def checked():
        before = [s is not None for s in eng.slots]
        admit()
        for i, s in enumerate(eng.slots):
            if s is None or before[i]:
                continue
            counts["admitted"] += 1
            counts["into_used_slots"] += i in used
            used.add(i)
            for path, t in cache_leaves(eng.cache):
                if path[-1] in POSITIONAL + (RING,):
                    continue
                counts["state_rows"] += 1
                check(not bool(t[:, i].any()),
                      f"slot {i} admitted with state in {'/'.join(path)}")
            for path, ring in eng.ring.items():
                counts["ring_rows"] += 1
                check(bool((ring[:, i] == EMPTY_POS).all()),
                      f"slot {i} admitted with a written ring row "
                      f"{'/'.join(path)}")
    eng._admit = checked
    return counts


def serve_aligned(device, seed: int, model, params, prompt: int,
              max_new: int) -> dict:
    """``ServeEngine`` at batch 4, max_seq 512, over the model's first
    ``ENGINE_LAYERS`` layers: 8 aligned requests of ``prompt`` tokens and
    ``max_new`` new ones, the second four in the slots the first four used
    (``checked_admissions``). Every request finishes with its tokens, and
    the page table returns each swapped page exactly (MLA: the latent
    ``c``; a recurrent first block swaps nothing); the absorbed MLA decode
    is counted where the config asks for it."""
    from repro_torch.layers import mla as M
    from repro_torch.models import Model
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.engine import Request
    if model.cfg.n_layers > ENGINE_LAYERS:
        emit("reduced", lm_arch=model.cfg.name, engine_layers=ENGINE_LAYERS,
             of=model.cfg.n_layers, why="the engine's checks (admissions "
             "into used slots, fresh recurrent rows and ring rows, swapped "
             "pages, the absorbed decode) hold at every depth, and its "
             "host-bound decode steps cost about the same a layer; "
             "minitron's engine (lm_serve) keeps its full depth")
        model = Model(dataclasses.replace(model.cfg, n_layers=ENGINE_LAYERS))
    rng = np.random.default_rng(seed + 7)
    vocab = model.cfg.vocab
    eng = ServeEngine(model, params, batch_size=LM_SERVE_BATCH,
                      max_seq=LM_SERVE_MAX_SEQ, device=device)
    admissions = checked_admissions(eng)
    stored: dict = {}
    store = eng.kv_store.store

    def keep(seq_id, kv):
        stored[seq_id] = kv.copy()
        return store(seq_id, kv)
    eng.kv_store.store = keep
    for i in range(ALIGNED_REQUESTS):
        eng.submit(Request(seq_id=i, prompt=rng.integers(
            0, vocab, prompt).astype(np.int32), max_new=max_new))
    absorbed = [0]
    orig = M._decode_absorbed

    def count(*a):
        absorbed[0] += 1
        return orig(*a)
    M._decode_absorbed = count
    try:
        fin, run_s = timed(eng.run, device)
    finally:
        M._decode_absorbed = orig
    fin = {f.seq_id: f for f in fin}
    check(sorted(fin) == list(range(ALIGNED_REQUESTS)),
          f"{model.cfg.name}: finished {sorted(fin)}")
    for sid, f in fin.items():
        check(f.tokens.size == max_new
              and bool(((f.tokens >= 0) & (f.tokens < vocab)).all()),
              f"{model.cfg.name}: request {sid}: {f.tokens.size} tokens")
        check(sid not in stored or np.array_equal(
            eng.kv_store.fetch(sid, stored[sid].shape[0]), stored[sid]),
            f"{model.cfg.name}: request {sid}: fetched pages differ")
    pages = sum(f.swapped_pages for f in fin.values())
    check(len(eng.kv_store.table) == pages, "page table misses pages")
    first = eng.cache["seg0"]["blk0"]
    latent = "c" in first
    swapped = "latent c" if latent else "k, v" if "k" in first else None
    check((pages > 0) == (swapped is not None)
          and len(stored) == (ALIGNED_REQUESTS if swapped else 0),
          f"{model.cfg.name}: {pages} pages swapped of {swapped}")
    check((absorbed[0] > 0) == (latent and model.cfg.mla_absorb),
          f"{model.cfg.name}: {absorbed[0]} absorbed MLA decode calls")
    check(admissions["admitted"] == ALIGNED_REQUESTS
          and admissions["into_used_slots"] == ALIGNED_REQUESTS
          - LM_SERVE_BATCH, f"{model.cfg.name}: admissions {admissions}")
    generated = ALIGNED_REQUESTS * max_new
    return dict(requests=ALIGNED_REQUESTS, batch=LM_SERVE_BATCH,
                max_seq=LM_SERVE_MAX_SEQ, prompt=prompt, max_new=max_new,
                mla_absorb=model.cfg.mla_absorb,
                absorbed_decode_calls=absorbed[0],
                engine_steps=eng.steps, run_s=run_s,
                generated_tokens=generated,
                decode_tokens_per_s=generated / run_s,
                swapped=swapped, pages=pages,
                page_width=int(stored[0].shape[1]) if stored else 0,
                page_table_rebuilds=eng.kv_store.table.rebuilds,
                fetch_exact=True, admissions=admissions)


def drawn_model(device, seed: int, cfg):
    """The model, random weights from ``seed`` drawn on ``device``, their
    count, and the seconds drawing took."""
    from repro_torch.models import Model
    model = Model(cfg)
    params, init_s = timed(lambda: model.init(seed, device=device), device)
    return model, params, sum(t.numel() for t in _leaves(params)), init_s


def lm_moe_deepseek(device, seed: int, cfg, seq: int, prompt: int,
                    max_new: int) -> dict:
    """deepseek-v2 (MLA and the MoE): the bf16 prefill (the main path, then
    again with CUDA events around the MLA attention for its share); the
    float32 prefill-against-decode check with the naive and the absorbed
    MLA decode, and the two decodes against each other; ``ServeEngine`` on
    the production config (absorbed decode)."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.registry import with_production
    from repro_torch.models import Model
    from repro_torch.models.steps import make_prefill_step
    full = get_config(MOE_DEEPSEEK)
    emit("reduced", lm_arch=cfg.name, n_layers=cfg.n_layers,
         of=full.n_layers, why=f"{full.n_params() * 4 / 2**30:.0f} GiB of "
         "float32 parameters cannot be held on one card (four would not "
         "hold them either); the dense layer 0 and two MoE layers of 160 "
         "experts keep one period of the layer pattern at full width",
         prefill_seq=seq, prefill_of=SHAPES["prefill_32k"].seq_len,
         prefill_why="the plain MLA attention (the reference's jnp "
         "flash_attention; K5 takes no 192-wide key) holds [1, S, 128, 1024] "
         "float32 scores a key chunk: 2.1 GB at 4,096 tokens, 17.2 GB at "
         "32,768, and as much again for p")
    model, params, n_params, init_s = drawn_model(device, seed, cfg)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    _, warm_s = timed(lambda: prefill(params, {"tokens": tokens[:, :256]}),
                      device)
    main = {}
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               init_s=init_s, warmup_s=warm_s,
               **prefill_main_path(device, cfg, prefill, params, tokens,
                                   keep=main))
    # the attention's share of a second prefill, device time on both sides
    out.update(share_of_prefill(device, prefill, params, tokens, "mla",
                                cfg.n_layers))
    # the MLA layout and the gspmd MoE over the mesh (lm_layout_families)
    out["layout"] = layout_family(
        device, cfg, params, tokens, main.pop("logits"), decodes=(
            ("naive", dataclasses.replace(cfg, mla_absorb=False), 0),
            ("absorbed", dataclasses.replace(cfg, mla_absorb=True), 0)))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    few = tokens[:, :LM_CHECK_TOKENS]
    out["check_naive"], dec_naive = lm_prefill_check(
        device, cfg32, params, few, phase="lm_moe_check")
    out["check_absorbed"], dec_abs = lm_prefill_check(
        device, dataclasses.replace(cfg32, mla_absorb=True), params, few,
        phase="lm_moe_check")
    out["naive_vs_absorbed"] = logit_agreement(dec_naive, dec_abs)
    check(out["naive_vs_absorbed"]["argmax_equal"]
          and out["naive_vs_absorbed"]["max_rel_err"] <= 1e-3,
          f"naive and absorbed decode disagree: {out['naive_vs_absorbed']}")
    del dec_naive, dec_abs
    out["serve"] = serve_aligned(device, seed,
                                 Model(with_production(cfg, MOE_DEEPSEEK)),
                                 params, prompt, max_new)
    return out


def moe_layers_that_fit(device, cfg) -> int:
    """The most layers of ``cfg`` whose float32 weights (experts padded),
    beside ``MOE_PREFILL_WORKSPACE``, fit in the card's free memory."""
    import torch
    from repro_torch.layers.moe import padded_experts
    if device.type != "cuda":
        return cfg.n_layers
    padded = dataclasses.replace(cfg, n_experts=padded_experts(
        cfg.n_experts))
    fixed = dataclasses.replace(padded, n_layers=0).n_params() * 4
    per_layer = (padded.n_params() * 4 - fixed) / cfg.n_layers
    free = torch.cuda.mem_get_info(device)[0] - MOE_PREFILL_WORKSPACE
    return max(1, min(cfg.n_layers, int((free - fixed) // per_layer)))


def lm_moe_qwen(device, seed: int, cfg, seq: int, prompt: int,
                max_new: int) -> dict:
    """qwen2-moe (GQA through K5 and the MoE): a recorded bf16 prefill
    whose first and last K5 launches are replayed through the plain version
    and timed beside it, its bound and SDPA; the main-path prefill (one K5
    launch a layer, all on the Hopper kernel); the float32
    prefill-against-decode check; ``ServeEngine``."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.configs.registry import with_production
    from repro_torch.layers.moe import padded_experts
    from repro_torch.models import Model
    from repro_torch.models.steps import make_prefill_step
    n = moe_layers_that_fit(device, cfg)
    if n < cfg.n_layers:
        emit("reduced", lm_arch=cfg.name, n_layers=n, of=cfg.n_layers,
             why="the float32 weights of every layer (experts padded from "
             f"{cfg.n_experts} to {padded_experts(cfg.n_experts)}) and the "
             "prefill's workspace exceed the card's free memory")
        cfg = dataclasses.replace(cfg, n_layers=n)
    emit("reduced", lm_arch=cfg.name, lm_prefill_batch=1,
         of=SHAPES["prefill_32k"].global_batch, why="prefill_32k's global "
         "batch of 32 cut to one sequence on one card")
    model, params, n_params, init_s = drawn_model(device, seed, cfg)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    _, warm_s = timed(lambda: prefill(params, {"tokens": tokens[:, :256]}),
                      device)
    last = cfg.n_layers - 1
    with recorded_attention(keep={0, last}) as rec:
        prefill(params, {"tokens": tokens})
    check(len(rec.dtypes) == cfg.n_layers,
          f"{len(rec.dtypes)} K5 calls for {cfg.n_layers} layers")
    replays = [replay_k5_launch(call, "lm_moe_replay")
               for call in rec.calls]
    _, q, k, v, kw, _ = rec.calls[-1]
    del rec
    times = k5_times(q, k, v, kw, device)
    del q, k, v
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               init_s=init_s, warmup_s=warm_s,
               **prefill_main_path(device, cfg, prefill, params, tokens),
               replayed_launches=[r["launch"] for r in replays],
               **replay_summary(replays), **times)
    if device.type == "cuda":
        check(out["k5_launches"] == cfg.n_layers,
              f"K5 launched {out['k5_launches']} times in a prefill of "
              f"{cfg.n_layers} layers")
        check(out["k5_kernels"] == ["flash_attention_sm90"],
              f"the prefill's K5 launches took {out['k5_kernels']}")
    out["kernel_share_of_prefill"] = (out["k5_launches"] * out["kernel_ms"]
                                      / (out["ttft_s"] * 1e3))
    out["check"], _ = lm_prefill_check(
        device, dataclasses.replace(cfg, dtype="float32"), params,
        tokens[:, :LM_CHECK_TOKENS], phase="lm_moe_check")
    out["serve"] = serve_aligned(device, seed,
                                 Model(with_production(cfg, MOE_QWEN)), params,
                                 prompt, max_new)
    return out, cfg, params


def phase_lm_moe(device, seed: int, deepseek_cfg=None, qwen_cfg=None,
                 deepseek_seq: int = DEEPSEEK_PREFILL_SEQ,
                 qwen_seq: int = LM_PREFILL_SEQ, prompt: int = 64,
                 max_new: int = 32) -> tuple:
    """The MoE family at full width, one model after the other (the first
    freed before the second is drawn): deepseek-v2 cut to
    ``DEEPSEEK_LAYERS`` layers, qwen2-moe at its full depth if the card
    holds it. -> (the record, qwen2-moe's config and parameters, which the
    ``lm_parallel`` phase takes over)."""
    import torch
    from repro_torch.configs import get_config
    deepseek_cfg = deepseek_cfg or dataclasses.replace(
        get_config(MOE_DEEPSEEK), n_layers=DEEPSEEK_LAYERS)
    qwen_cfg = qwen_cfg or get_config(MOE_QWEN)
    ds = lm_moe_deepseek(device, seed, deepseek_cfg, deepseek_seq, prompt,
                         max_new)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    qw, cfg, params = lm_moe_qwen(device, seed, qwen_cfg, qwen_seq, prompt,
                                  max_new)
    out = {"deepseek_v2": ds, "qwen2_moe": qw}
    emit("lm_moe", **out)
    return out, cfg, params


# ------------------------------------------------------ over a mesh ----

PARALLEL_PREFILL_SEQ = 4096
PARALLEL_ROWS = 256            # logit rows compared: every 16th position
PARALLEL_TOL = 1e-6            # one rank: the same function, op for op
PARALLEL_GRAD_LAYERS = 2
PARALLEL_GRAD_SEQ = 512
PARALLEL_GRAD_TOL = 1e-5       # float32; the gathers' backward adds by atomics


def start_process_group(backend: str, device) -> str:
    """A one-rank process group over a file store in a new temporary
    directory (returned; the caller removes it)."""
    import tempfile
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/store", rank=0, world_size=1,
        **({"device_id": device} if device.type == "cuda" else {}))
    return tmp


class one_rank_mesh:
    """A one-rank process group (NCCL on the card) and ``make_local_mesh``'s
    (1, 1) mesh over it; the group is destroyed on exit."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from repro_torch.launch.mesh import make_local_mesh
        self.pg_dir = start_process_group(
            "nccl" if self.device.type == "cuda" else "gloo", self.device)
        return make_local_mesh(self.device.type)

    def __exit__(self, *exc):
        import shutil
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(self.pg_dir, ignore_errors=True)
        return False


def grad_agreement(want: list, got: list) -> dict:
    """Per leaf: the largest |difference| over the leaf's largest |value|;
    the worst leaf."""
    rel = [float((w - g).abs().max() / w.abs().max().clamp_min(1e-30))
           for w, g in zip(want, got)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    return dict(leaves=len(rel), max_rel_err=rel[worst], worst_leaf=worst,
                tol=PARALLEL_GRAD_TOL)


def phase_lm_parallel(device, seed: int, cfg, params, card: str,
                      seq: int = PARALLEL_PREFILL_SEQ,
                      grad_seq: int = PARALLEL_GRAD_SEQ) -> dict:
    """qwen2-moe over a device mesh, on ``params`` (``lm_moe``'s): a
    one-rank process group (NCCL on the card) and ``make_local_mesh``'s
    (1, 1) mesh; the production ``moe_impl="shard_map"`` under it runs the
    expert-parallel MoE. The main path: a bf16 prefill of ``seq`` tokens,
    K5's and the expert-parallel all-reduce's counts at 0 just before and
    read just after (one of each a layer, K5 on the Hopper kernel), its
    first and last K5 launches replayed through the plain version and K5
    timed at the last one's inputs beside its plain version and SDPA; the
    gspmd prefill of the same tokens beside it, and both forwards' logits
    at ``PARALLEL_ROWS`` positions held together (``PARALLEL_TOL``: with
    one rank the two compute the same function op for op); ``loss_and_grad``
    of ``PARALLEL_GRAD_LAYERS`` layers in float32 through both paths, every
    leaf within ``PARALLEL_GRAD_TOL``; ``tree_shardings`` of the full tree
    under FSDP's rule on the mesh and on the production (16, 16) shape; a
    two-layer checkpoint saved and ``restore_sharded`` onto the mesh, equal
    bit for bit."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import with_production
    from repro_torch.convert import lm_arrays_from_params, stacked_axes
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_local_mesh, production_mesh_shape
    from repro_torch.layers import moe as M
    from repro_torch.models import Model
    from repro_torch.models.steps import loss_and_grad, make_prefill_step
    from repro_torch.parallel.collectives import LOG
    from repro_torch.parallel import (LOGICAL_RULES, fsdp_rules,
                                      set_mesh_rules, tree_shardings)
    ep_cfg = with_production(cfg, MOE_QWEN)
    check(ep_cfg.moe_impl == "shard_map", f"{MOE_QWEN}'s production "
          f"moe_impl is {ep_cfg.moe_impl}")
    gs_cfg = dataclasses.replace(ep_cfg, moe_impl="gspmd")
    moe_layers = sum(cfg.layer_kind(i)[1] == "moe"
                     for i in range(cfg.n_layers))
    backend = "nccl" if device.type == "cuda" else "gloo"
    gc.collect()
    if device.type == "cuda":       # lm_moe's prefill blocks, back first
        torch.cuda.empty_cache()
    pg_dir = start_process_group(backend, device)
    try:
        mesh = make_local_mesh(device.type)
        gen = torch.Generator(device=device).manual_seed(seed + 12)
        tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                               device=device)
        batch = {"tokens": tokens}
        ep_model, gs_model = Model(ep_cfg), Model(gs_cfg)
        ep_step = make_prefill_step(ep_model)

        def ep_prefill(p, b):
            with set_mesh_rules(mesh):
                return ep_step(p, b)
        gs_prefill = make_prefill_step(gs_model)
        ep_prefill(params, {"tokens": tokens[:, :256]})
        gs_prefill(params, {"tokens": tokens[:, :256]})
        # ---- the main path: the expert-parallel prefill, counted; its
        # first and last K5 launches kept for the replay
        last = cfg.n_layers - 1
        with recorded_attention(keep={0, last}) as att:
            FA.launches = 0
            LOG.reset()         # M.ep_all_reduces is a view of its tags
            ep_logits, ep_s = timed(lambda: ep_prefill(params, batch),
                                    device)
            launches, reduces = FA.launches, M.ep_all_reduces
        # ---- end of the main path
        check(len(att.calls) == len({0, last}),
              f"{len(att.calls)} K5 launches kept of {len(att.dtypes)}")
        replays = [replay_k5_launch(call, "lm_parallel_replay")
                   for call in att.calls]
        _, q, k, v, kw, _ = att.calls[-1]
        att.calls.clear()
        times = k5_times(q, k, v, kw, device)
        del q, k, v
        gs_logits, gs_s = timed(lambda: gs_prefill(params, batch), device)
        turns = {"ep": [], "gspmd": []}        # in turns, after both ran
        for name in ("gspmd", "ep", "ep", "gspmd"):
            fn = ep_prefill if name == "ep" else gs_prefill
            turns[name].append(timed(lambda: fn(params, batch), device)[1])
        # the device time of the layout's all-reduces in a prefill (under
        # LOGICAL_RULES: the vocab-parallel embedding's, each layer's
        # attention's, each MoE layer's expert-parallel sum and aux's
        # batch mean)
        collective = share_of_prefill(
            device, ep_prefill, params, tokens, "parallel.collectives",
            1 + cfg.n_layers + 2 * moe_layers, "all_reduce_", "all_reduce")
        check(tuple(ep_logits.shape) == (1, cfg.vocab)
              and bool(torch.isfinite(ep_logits.float()).all()),
              "expert-parallel prefill logits not finite or misshapen")
        kernels = sorted({FA.KERNELS[dt] for dt in att.dtypes})
        if device.type == "cuda":
            check(launches == cfg.n_layers and kernels == [
                "flash_attention_sm90"], f"K5: {launches} launches on "
                f"{kernels} in a prefill of {cfg.n_layers} layers")
        check(reduces == moe_layers, f"{reduces} expert-parallel "
              f"all-reduces in a prefill of {moe_layers} MoE layers")
        rows = torch.arange(seq // PARALLEL_ROWS - 1, seq,
                            seq // PARALLEL_ROWS, device=device)
        with set_mesh_rules(mesh):
            x_ep, _ = ep_model.forward(params, batch)
        x_gs, _ = gs_model.forward(params, batch)
        hidden_equal = bool(torch.equal(x_ep, x_gs))
        agree = logit_agreement(
            gs_model.logits(params, x_gs[0, rows]).float(),
            ep_model.logits(params, x_ep[0, rows]).float(), PARALLEL_TOL)
        del x_ep, x_gs
        check(agree["argmax_equal"] and agree["max_rel_err"] <= PARALLEL_TOL,
              f"expert-parallel and gspmd prefills disagree: {agree}")
        # the production layout (FSDP's gather, tensor parallelism and the
        # expert-parallel MoE) against the unsharded gspmd prefill
        layout = layout_prefill(device, ep_cfg, params, tokens, mesh,
                                "lm_parallel_layout", whole_cfg=gs_cfg)

        # float32 gradients of a two-layer cut through both paths
        n = PARALLEL_GRAD_LAYERS
        params2 = {**params, "seg0": {"blk0": params["seg0"]["blk0"][:n]}}
        cut = dict(n_layers=n, dtype="float32")
        g = torch.Generator(device=device).manual_seed(seed + 13)
        gbatch = {k: torch.randint(0, cfg.vocab, (1, grad_seq), generator=g,
                                   device=device)
                  for k in ("tokens", "labels")}
        ep_cut = Model(dataclasses.replace(ep_cfg, **cut))
        gs_cut = Model(dataclasses.replace(gs_cfg, **cut))

        def ep_grad():
            with set_mesh_rules(mesh):
                return loss_and_grad(ep_cut, params2, gbatch)
        LOG.reset()
        ep_loss, ep_grads = ep_grad()
        grad_reduces = M.ep_all_reduces
        gs_loss, gs_grads = loss_and_grad(gs_cut, params2, gbatch)
        grads = grad_agreement(gs_grads, ep_grads)
        del ep_grads, gs_grads
        # timed once both have run (the first call of each builds and
        # allocates), in turns
        gs_grad_s = timed(lambda: loss_and_grad(gs_cut, params2, gbatch),
                          device)[1]
        ep_grad_s = timed(ep_grad, device)[1]
        check(grads["max_rel_err"] <= PARALLEL_GRAD_TOL
              and abs(float(ep_loss) - float(gs_loss))
              <= PARALLEL_GRAD_TOL * abs(float(gs_loss)),
              f"expert-parallel and gspmd gradients disagree: {grads}, "
              f"losses {float(ep_loss)} {float(gs_loss)}")

        # the full tree's placement, and the two-layer checkpoint restored
        _, axes = Model(cfg).init_with_axes(device="meta")
        rules = dict(LOGICAL_RULES, **fsdp_rules(False))
        full = tree_shardings(params, axes, mesh, rules)
        prod = tree_shardings(params, axes, production_mesh_shape(), rules)
        per_rank = sum(math.prod(s.shard_shape(p.shape)) * p.element_size()
                       for s, p in zip(_leaves(prod), _leaves(params)))
        full = list(_leaves(full))
        cfg2 = dataclasses.replace(cfg, n_layers=n)
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            state = lm_arrays_from_params(cfg2, params2)
            mgr = CheckpointManager(ckpt_dir)
            _, save_s = timed(lambda: mgr.save(0, state), device)
            sh = tree_shardings(state, stacked_axes(axes), mesh, rules)
            (step, restored), restore_s = timed(
                lambda: mgr.restore_sharded(state, sh), device)
            ckpt_bytes = sum(a.nbytes for a in _leaves(state))
            same = all(r.device == device and torch.equal(
                r, torch.from_numpy(a).to(device))
                for r, a in zip(_leaves(restored), _leaves(state)))
            del state, restored
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        check(step == 0 and same, "the restored checkpoint differs")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    out = dict(
        arch=cfg.name, n_layers=cfg.n_layers, moe_layers=moe_layers,
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), backend=backend,
        seq=seq, card=card, k5_launches=launches, k5_kernels=kernels,
        replayed_launches=[r["launch"] for r in replays],
        **replay_summary(replays), **times,
        ep_all_reduces=reduces, ep_prefill_s=ep_s, gspmd_prefill_s=gs_s,
        turns_s=turns, ep_over_gspmd=sum(turns["ep"]) / sum(turns["gspmd"]),
        **collective, logits=agree, hidden_equal=hidden_equal,
        last_logits_equal=bool(torch.equal(ep_logits, gs_logits)),
        layout={k: layout[k] for k in (
            "prefill_s", "k5_launches", "k5_kernels", "collectives",
            "max_memory_allocated_step", "max_abs_err", "hidden_equal",
            "logit_rows_equal", "last_logits_equal")},
        grad=dict(layers=n, seq=grad_seq, dtype="float32",
                  ep_all_reduces=grad_reduces, ep_s=ep_grad_s,
                  gspmd_s=gs_grad_s, loss=float(ep_loss),
                  gspmd_loss=float(gs_loss), **grads),
        placement=dict(leaves=len(full),
                       specs_nonempty=sum(bool(s.spec) for s in full),
                       fsdp_bytes_per_rank_16x16=per_rank,
                       bytes_whole=sum(p.numel() * p.element_size()
                                       for p in _leaves(params))),
        restore=dict(layers=n, bytes=ckpt_bytes, save_s=save_s,
                     restore_s=restore_s, equal=same))
    emit("lm_parallel", **out)
    return out


# ---------------------------------------------- the production layout ----

LAYOUT_ROWS = 256              # logit rows held bit for bit: every 128th
LAYOUT_PEAK_TOL = 0.25         # a dry-run peak within 25% of the card's


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def step_peak(device, fn, held: int):
    """``fn()`` with the card's peak of the step's own bytes: the peak
    allocated during the call, less what was allocated before it, plus
    ``held`` (the bytes of the step's arguments, which the dry run counts
    in its peak). -> (``fn()``, seconds, that peak)."""
    import torch
    if device.type != "cuda":
        out, sec = timed(fn, device)
        return out, sec, None
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out, sec = timed(fn, device)
    return out, sec, torch.cuda.max_memory_allocated(device) - before + held


def layout_prefill(device, cfg, params, tokens, mesh, phase: str,
                   whole_cfg=None) -> dict:
    """``cfg``'s bf16 prefill of ``tokens`` through the production layout
    (``parallel.collectives``) on the one-rank ``mesh`` under
    ``LOGICAL_RULES`` with ``fsdp_rules``: every weight's ``embed`` dim
    gathered at use, the heads, kv heads, MLP and vocab on ``model``
    (column- and row-parallel products ending in a reduce over ``model``,
    the vocab-parallel embedding and LM head). The main path: K5's count
    and the collective log at 0 just before, read just after (one launch a
    layer, all on the Hopper kernel), its time and peak (``step_peak``);
    then again with K5's launches 0 and last kept and replayed through the
    plain version; then the unsharded prefill of the same tokens
    (``whole_cfg``, default ``cfg``, with no mesh): the hidden states, the
    last position's logits and the logits at ``LAYOUT_ROWS`` positions
    must equal the layout's bit for bit."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import Model
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.parallel import fsdp_rules, set_mesh_rules
    from repro_torch.parallel.collectives import LOG
    over = fsdp_rules(False)
    model, whole = Model(cfg), Model(whole_cfg or cfg)
    step, whole_step = make_prefill_step(model), make_prefill_step(whole)
    batch = {"tokens": tokens}

    def run(b):
        with set_mesh_rules(mesh, over):
            return step(params, b)
    run({"tokens": tokens[:, :256]})
    held = _nbytes(params) + _nbytes(tokens)
    # ---- the main path: the layout's prefill, counted
    with recorded_attention(keep=()) as att:
        FA.launches = 0
        LOG.reset()
        logits, sec, peak = step_peak(device, lambda: run(batch), held)
        launches, coll = FA.launches, LOG.as_dict()
    # ---- end of the main path
    kernels = sorted({FA.KERNELS[dt] for dt in att.dtypes})
    if device.type == "cuda":
        check(launches == cfg.n_layers
              and kernels == ["flash_attention_sm90"],
              f"{phase}: K5 {launches} launches on {kernels} in a prefill "
              f"of {cfg.n_layers} layers")
    last = cfg.n_layers - 1
    with recorded_attention(keep={0, last}) as rec:
        rec_logits = run(batch)
    check(len(rec.calls) == len({0, last}),
          f"{phase}: {len(rec.calls)} K5 launches kept")
    replays = [replay_k5_launch(call, f"{phase}_replay")
               for call in rec.calls]
    del rec
    seq = tokens.shape[1]
    rows = torch.arange(seq // LAYOUT_ROWS - 1, seq, seq // LAYOUT_ROWS,
                        device=device)
    with set_mesh_rules(mesh, over):
        x_lay, _ = model.forward(params, batch)
        lay_rows = model.logits(params, x_lay[0, rows])
    x_whole, _ = whole.forward(params, batch)
    whole_rows = whole.logits(params, x_whole[0, rows])
    whole_logits = whole_step(params, batch)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, seq=seq,
               mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               rules="LOGICAL_RULES + fsdp_rules(False)", prefill_s=sec,
               k5_launches=launches, k5_kernels=kernels, collectives=coll,
               max_memory_allocated_step=peak, held_bytes=held,
               replayed_launches=[r["launch"] for r in replays],
               **replay_summary(replays),
               hidden_equal=bool(torch.equal(x_lay, x_whole)),
               logit_rows_equal=bool(torch.equal(lay_rows, whole_rows)),
               last_logits_equal=bool(torch.equal(logits, whole_logits)),
               recorded_equal=bool(torch.equal(logits, rec_logits)))
    del x_lay, x_whole
    emit(phase, **out)
    check(out["hidden_equal"] and out["logit_rows_equal"]
          and out["last_logits_equal"] and out["recorded_equal"],
          f"{phase}: the layout's prefill is not the unsharded one bit for "
          f"bit: {out}")
    return out


def phase_lm_layout_prefill(device, seed: int, model, params,
                            seq: int = LM_PREFILL_SEQ) -> dict:
    """minitron-4b's ``lm_prefill`` tokens (the same generator) through
    ``layout_prefill`` over a one-rank process group (NCCL on the card) and
    its (1, 1) mesh."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    with one_rank_mesh(device) as mesh:
        return layout_prefill(device, cfg, params, tokens, mesh,
                              "lm_layout_prefill")


def layout_train_step(device, model, params, opt, batch, lr: float) -> dict:
    """One ``make_train_step`` step through the layout, on the state that
    ``train_main_path`` trained (a one-rank process group, (1, 1) mesh,
    ``LOGICAL_RULES`` + ``fsdp_rules``): its time, peak (``step_peak``),
    K5 launches and collectives, for the dry run's prediction."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.steps import make_train_step
    from repro_torch.parallel import fsdp_rules, set_mesh_rules
    from repro_torch.parallel.collectives import LOG
    with one_rank_mesh(device) as mesh:
        step = make_train_step(model, lr=lr)
        held = _nbytes(params) + _nbytes([opt.step, opt.m, opt.v]) + \
            _nbytes(list(batch.values()))

        def run():
            with set_mesh_rules(mesh, fsdp_rules(False)):
                return step(params, opt, batch)
        FA.launches = 0
        LOG.reset()
        (loss, _, _), sec, peak = step_peak(device, run, held)
        out = dict(loss=float(loss), seconds=sec, k5_launches=FA.launches,
                   collectives=LOG.as_dict(), max_memory_allocated_step=peak,
                   held_bytes=held)
    check(bool(np.isfinite(out["loss"])), f"the layout's train step's loss "
          f"is {out['loss']}")
    return out


def phase_lm_layout(device, card: str, prefill: dict, train: dict,
                    train_seq: int, train_batch: int, train_cfg=None,
                    prefill_cfg=None) -> dict:
    """The dry run against the card: ``launch.dryrun.trace_cell`` on a
    fake (1, 1) mesh predicts qwen2-vl-2b's training step at ``lm_train``'s
    shape and minitron-4b's 32,768-token prefill, the programs the card
    ran through the layout (``layout_train_step``, ``layout_prefill``).
    Each prediction beside the card's peak of the same step, and the
    counted FLOPs over the measured step time; fails if a predicted peak
    is more than ``LAYOUT_PEAK_TOL`` from the measured one."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_mesh, trace_cell
    from repro_torch.parallel import LOGICAL_RULES, MeshShape, fsdp_rules
    over = fsdp_rules(False)
    rules = dict(LOGICAL_RULES, **over)
    cells = {
        "qwen2_vl_train": (train_cfg or get_config(VL_ARCH), ShapeConfig(
            TRAIN_SHAPE, train_seq, train_batch, "train"), train,
            "seconds"),
        "minitron_prefill": (prefill_cfg or get_config(LM_ARCH), ShapeConfig(
            "prefill_32k", prefill["seq"], 1, "prefill"), prefill,
            "prefill_s")}
    out = {"card": card, "hbm_bytes": (
        torch.cuda.get_device_properties(device).total_memory
        if device.type == "cuda" else None)}
    with fake_mesh(MeshShape(("data", "model"), (1, 1))) as mesh:
        for name, (cfg, shape, measured, key) in cells.items():
            t = trace_cell(cfg, shape, mesh, rules, over)
            pred = t["memory"]["peak_bytes"]
            meas = measured["max_memory_allocated_step"]
            out[name] = dict(
                arch=cfg.name, kind=shape.kind, seq=shape.seq_len,
                batch=shape.global_batch, trace_s=t["trace_s"],
                predicted_peak_bytes=pred, measured_peak_bytes=meas,
                peak_rel_err=(None if meas is None else (pred - meas) / meas),
                predicted_held_bytes=t["memory"]["held_bytes"],
                measured_held_bytes=measured["held_bytes"],
                flops=t["flops"], bytes=t["bytes"],
                step_s=measured[key],
                tflops_per_s=t["flops"] / measured[key] / 1e12,
                predicted_collectives=t["collectives"],
                measured_collectives=measured["collectives"])
    emit("lm_layout", **out)
    if device.type == "cuda":
        for name in cells:
            err = out[name]["peak_rel_err"]
            check(abs(err) <= LAYOUT_PEAK_TOL, f"lm_layout: the dry run's "
                  f"{name} peak is {err:+.1%} from the card's")
    return out


# ----------------------------------------------------- the recurrent ----

RWKV_ARCH = "rwkv6-1.6b"
GRIFFIN_ARCH = "recurrentgemma-9b"
RING_CHECK_LAYERS = 3          # one (rglru, rglru, wattn) pattern
RING_CHECK_TOKENS = 2112       # 64 past recurrentgemma's window of 2,048


def recurrent_prefill(device, seed: int, cfg, seq: int) -> tuple:
    """The model at ``cfg`` (random weights from ``seed`` drawn on the
    device) and the main path of its bf16 prefill of ``seq`` tokens
    (``prefill_main_path``; no K5 launch may run, since neither the
    recurrences nor the windowed attention are K5's function). Returns the
    record, the prefill step, the model, its weights, the tokens and the
    prefill's logits."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.models.steps import make_prefill_step
    emit("reduced", lm_arch=cfg.name, lm_prefill_batch=1,
         of=SHAPES["prefill_32k"].global_batch, why="prefill_32k's global "
         "batch of 32 cut to one sequence on one card")
    model, params, n_params, init_s = drawn_model(device, seed, cfg)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    _, warm_s = timed(lambda: prefill(params, {"tokens": tokens[:, :256]}),
                      device)
    main = {}
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               init_s=init_s, warmup_s=warm_s,
               **prefill_main_path(device, cfg, prefill, params, tokens,
                                   keep=main))
    check(out["k5_launches"] == 0 and out["k5_calls"] == 0,
          f"{cfg.name}: {out['k5_calls']} K5 calls in the prefill")
    return out, prefill, model, params, tokens, main["logits"]


def lm_recurrent_rwkv(device, seed: int, cfg, seq: int, prompt: int,
                      max_new: int) -> dict:
    """rwkv6: the bf16 prefill (the main path), again with CUDA events
    around each layer's chunked WKV for its share; the float32
    prefill-against-decode check at full depth; ``ServeEngine``."""
    out, prefill, model, params, tokens, logits = recurrent_prefill(
        device, seed, cfg, seq)
    out.update(share_of_prefill(device, prefill, params, tokens, "rwkv",
                                cfg.n_layers, "_wkv_chunked", "wkv"))
    # the RWKV6 layout (lm_layout_families)
    out["layout"] = layout_family(device, cfg, params, tokens, logits,
                                  decodes=(("decode", cfg, 0),))
    del logits
    out["check"], _ = lm_prefill_check(
        device, dataclasses.replace(cfg, dtype="float32"), params,
        tokens[:, :LM_CHECK_TOKENS], phase="lm_recurrent_check")
    out["serve"] = serve_aligned(device, seed, model, params, prompt, max_new)
    return out


def lm_recurrent_griffin(device, seed: int, cfg, seq: int, prompt: int,
                         max_new: int, ring_tokens: int = RING_CHECK_TOKENS
                         ) -> dict:
    """recurrentgemma: the bf16 prefill (the main path), again with CUDA
    events around each windowed attention for its share; the float32
    ring-wrap check at one pattern of layers (the same weights' first
    pattern: prefill against ``ring_tokens`` decode steps through the
    ring); ``ServeEngine`` on the production config (``kv_replicate_to``,
    which leaves the ring at its KV heads)."""
    from repro_torch.configs.registry import with_production
    from repro_torch.models import Model
    out, prefill, model, params, tokens, logits = recurrent_prefill(
        device, seed, cfg, seq)
    wattn = sum(cfg.layer_kind(i)[0] == "wattn" for i in range(cfg.n_layers))
    out.update(share_of_prefill(device, prefill, params, tokens,
                                "attention", wattn))
    del logits
    # the RG-LRU and windowed-attention layouts (lm_layout_families), at
    # one pattern of layers: the decode crosses the ring's wrap at its
    # fifth step
    cut = dataclasses.replace(cfg, n_layers=min(RING_CHECK_LAYERS,
                                                cfg.n_layers))
    emit("reduced", lm_arch=cfg.name, layout_layers=cut.n_layers,
         of=cfg.n_layers, why="the layout's prefill, the unsharded prefill "
         "it is held to bit for bit, both forwards' hidden states and the "
         "decodes run one (rglru, rglru, wattn) pattern: every kind of layer "
         "at full width, for a twelfth of the prefill's time")
    out["layout"] = layout_family(
        device, cut, params, tokens, decodes=(
            ("ring_wrap", cut, cfg.window - FAMILY_DECODE_STEPS // 2),))
    emit("reduced", lm_arch=cfg.name, ring_check_layers=RING_CHECK_LAYERS,
         of=cfg.n_layers, why="the float32 ring-wrap check decodes "
         f"{ring_tokens} tokens one at a time; one (rglru, rglru, wattn) "
         "pattern keeps it to seconds")
    cut = dataclasses.replace(cfg, n_layers=RING_CHECK_LAYERS,
                              dtype="float32")
    # a model of one pattern reads layer 0 of each block of the weights
    out["ring_check"], _ = lm_prefill_check(
        device, cut, params, tokens[:, :ring_tokens],
        phase="lm_recurrent_ring_check")
    out["ring_check"]["window"] = cfg.window
    out["serve"] = serve_aligned(device, seed,
                                 Model(with_production(cfg, GRIFFIN_ARCH)),
                                 params, prompt, max_new)
    return out


def phase_lm_recurrent(device, seed: int, rwkv_cfg=None, griffin_cfg=None,
                       seq: int = LM_PREFILL_SEQ, prompt: int = 64,
                       max_new: int = 32,
                       ring_tokens: int = RING_CHECK_TOKENS) -> dict:
    """The recurrent families at full width and depth, one model after the
    other (the first freed before the second is drawn): rwkv6, then
    recurrentgemma."""
    import torch
    from repro_torch.configs import get_config
    rwkv_cfg = rwkv_cfg or get_config(RWKV_ARCH)
    griffin_cfg = griffin_cfg or get_config(GRIFFIN_ARCH)
    rw = lm_recurrent_rwkv(device, seed, rwkv_cfg, seq, prompt, max_new)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gr = lm_recurrent_griffin(device, seed, griffin_cfg, seq, prompt,
                              max_new, ring_tokens)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"rwkv6": rw, "recurrentgemma": gr}
    emit("lm_recurrent", **out)
    return out


# -------------------------------- the MLA, RWKV6 and RG-LRU layouts ----

FAMILY_DECODE_STEPS = 8        # decode steps through each layout's cache


def layout_decode(device, cfg, params, tokens, mesh, over, start: int,
                  steps: int) -> dict:
    """``steps`` decode steps of ``tokens`` from position ``start``, through
    the layout's cache (``init_cache`` under ``mesh``: the rank's blocks)
    and through the unsharded cache: every step's logits bit for bit."""
    import contextlib
    import torch
    from repro_torch.models import Model, init_cache
    from repro_torch.parallel import set_mesh_rules
    model = Model(cfg)
    out = {}
    for name in ("layout", "whole"):
        with (set_mesh_rules(mesh, over) if name == "layout"
              else contextlib.nullcontext()):
            cache = init_cache(cfg, 1, start + steps, device=device)
            out[name] = torch.stack([model.serve_step(
                params, cache, tokens[:, t:t + 1], start + t)[0]
                for t in range(steps)])
    lay, whole = out["layout"], out["whole"]
    return dict(start=start, steps=steps, dtype=cfg.dtype,
                equal=bool(torch.equal(lay, whole)),
                max_abs_diff=float((lay.float() - whole.float()).abs().max()),
                finite=bool(torch.isfinite(whole.float()).all()))


def layout_family(device, cfg, params, tokens, whole_logits=None, *,
                  decodes=()) -> dict:
    """``cfg``'s bf16 prefill of ``tokens`` through the production layout
    (``LOGICAL_RULES`` with ``fsdp_rules``, a one-rank process group and
    its (1, 1) mesh; ``parallel.collectives``): the main path, K5's count
    and the collective log at 0 just before and read just after (no K5
    launch: MLA's, RWKV's and the windowed attention are plain), its time
    and peak (``step_peak``); its logits must equal ``whole_logits`` (the
    unsharded main path's; None: an unsharded prefill of ``cfg`` run here)
    bit for bit. Then the hidden states and the logits at ``LAYOUT_ROWS``
    positions of a forward through the layout and one without, bit for
    bit; each of ``decodes`` (``(name, config, start)``) through
    ``layout_decode``; and ``launch.dryrun.trace_cell`` of the same prefill
    on a fake (1, 1) mesh, whose predicted peak must lie within
    ``LAYOUT_PEAK_TOL`` of the card's. ``cfg`` may be a depth cut of the
    model ``params`` hold (its first layers). -> the record, with its
    ``seconds``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.dryrun import fake_mesh, trace_cell
    from repro_torch.models import Model
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.parallel import (LOGICAL_RULES, MeshShape, fsdp_rules,
                                      set_mesh_rules)
    from repro_torch.parallel.collectives import LOG
    t0 = time.perf_counter()
    over = fsdp_rules(False)
    model = Model(cfg)
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    if whole_logits is None:
        whole_logits = step(params, batch)
    # the arguments the step reads: the weights of cfg's layers, the tokens
    held = _nbytes(model.init(device="meta")) + _nbytes(tokens)
    seq = tokens.shape[1]
    with one_rank_mesh(device) as mesh:
        def run(b):
            with set_mesh_rules(mesh, over):
                return step(params, b)
        run({"tokens": tokens[:, :256]})
        # ---- the main path: the layout's prefill, counted
        FA.launches = 0
        LOG.reset()
        logits, sec, peak = step_peak(device, lambda: run(batch), held)
        launches, coll, tags = FA.launches, LOG.as_dict(), dict(LOG.tags)
        # ---- end of the main path
        prefill_equal = bool(torch.equal(logits, whole_logits))
        del logits, whole_logits
        rows = torch.arange(seq // LAYOUT_ROWS - 1, seq, seq // LAYOUT_ROWS,
                            device=device)
        with set_mesh_rules(mesh, over):
            x_lay, _ = model.forward(params, batch)
            lay_rows = model.logits(params, x_lay[0, rows])
        x_whole, _ = model.forward(params, batch)
        hidden_equal = bool(torch.equal(x_lay, x_whole))
        rows_equal = bool(torch.equal(lay_rows,
                                      model.logits(params, x_whole[0, rows])))
        del x_lay, x_whole
        dec = {name: layout_decode(device, dcfg, params, tokens, mesh, over,
                                   start, FAMILY_DECODE_STEPS)
               for name, dcfg, start in decodes}
    rules = dict(LOGICAL_RULES, **over)
    with fake_mesh(MeshShape(("data", "model"), (1, 1))) as fake:
        t = trace_cell(cfg, ShapeConfig("prefill_32k", seq, 1, "prefill"),
                       fake, rules, over)
    pred = t["memory"]["peak_bytes"]
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, seq=seq,
               mesh={"data": 1, "model": 1},
               rules="LOGICAL_RULES + fsdp_rules(False)", prefill_s=sec,
               k5_launches=launches, collectives=coll, tags=tags,
               prefill_equal=prefill_equal, hidden_equal=hidden_equal,
               logit_rows_equal=rows_equal, decode=dec,
               max_memory_allocated_step=peak, held_bytes=held,
               predicted_peak_bytes=pred, trace_s=t["trace_s"],
               peak_rel_err=(None if peak is None else (pred - peak) / peak),
               predicted_collectives=t["collectives"], flops=t["flops"],
               tflops_per_s=t["flops"] / sec / 1e12)
    check(launches == 0, f"{cfg.name}: {launches} K5 launches in the "
          "layout's prefill")
    check(prefill_equal and hidden_equal and rows_equal
          and all(d["equal"] and d["finite"] for d in dec.values()),
          f"{cfg.name}: the layout is not the unsharded model bit for bit: "
          f"{out}")
    check(coll == t["collectives"], f"{cfg.name}: the card's collectives "
          f"{coll} are not the dry run's {t['collectives']}")
    if device.type == "cuda":
        check(abs(out["peak_rel_err"]) <= LAYOUT_PEAK_TOL,
              f"{cfg.name}: the dry run's peak is "
              f"{out['peak_rel_err']:+.1%} from the card's")
    out["seconds"] = time.perf_counter() - t0
    emit("lm_layout_family", **out)
    return out


# ------------------------------------------------------ the frontends ----

HUBERT_ARCH = "hubert-xlarge"
VL_ARCH = "qwen2-vl-2b"
HUBERT_CHECK_LAYERS = 3        # the float32 kernel-against-plain check
HUBERT_CHECK_FRAMES = 1500     # 30 s of audio at 50 frames/s: ragged tiles
VL_PATCHES = 256               # launch/specs.py's patch embeddings a sample


class plain_attention:
    """Within the block, ``layers.attention.flash_attention_fwd`` is K5's
    plain version at the kernel's key tile (no launch): the same forward
    as the main path with the kernel taken out."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.layers import attention as A
        self._orig = A.flash_attention_fwd

        def plain(q, k, v, **kw):
            return FA.flash_attention_plain(
                q, k, v, block_k=FA.kernel_block_k(q.dtype, q.shape[-1]),
                **kw)
        A.flash_attention_fwd = plain
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import attention as A
        A.flash_attention_fwd = self._orig


def recorded_prefill(device, cfg, prefill, params, batch, phase: str
                     ) -> dict:
    """A prefill whose first and last K5 launches are kept, replayed
    through the plain version (``replay_k5_launch``) and timed at their
    shape beside the plain version, SDPA and the bound (``k5_times``)."""
    last = cfg.n_layers - 1
    with recorded_attention(keep={0, last}) as rec:
        prefill(params, batch)
    check(len(rec.dtypes) == cfg.n_layers,
          f"{cfg.name}: {len(rec.dtypes)} K5 calls for {cfg.n_layers} "
          "layers")
    replays = [replay_k5_launch(call, phase) for call in rec.calls]
    _, q, k, v, kw, _ = rec.calls[-1]
    del rec
    times = k5_times(q, k, v, kw, device)
    return dict(replayed_launches=[r["launch"] for r in replays],
                **replay_summary(replays), **times)


def lm_frontends_hubert(device, seed: int, cfg, seq: int,
                        check_frames: int = HUBERT_CHECK_FRAMES) -> dict:
    """hubert-xlarge (encoder-only, bidirectional, D 80): a recorded bf16
    encode of ``seq`` frame embeddings (its first and last K5 launches
    replayed and timed), the main path (``make_prefill_step``: one K5
    launch a layer, all on the Hopper kernel), then the float32 check at
    ``HUBERT_CHECK_LAYERS`` layers over ``check_frames`` frames: the
    forward through the SIMT kernel against the same forward through the
    plain version, every position's logits."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.models import Model
    from repro_torch.models.steps import make_prefill_step
    emit("reduced", lm_arch=cfg.name, lm_prefill_batch=1,
         of=SHAPES["prefill_32k"].global_batch, why="prefill_32k's global "
         "batch of 32 cut to one sequence on one card")
    model, params, n_params, init_s = drawn_model(device, seed, cfg)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    frames = torch.randn((1, seq, cfg.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
    _, warm_s = timed(lambda: prefill(params, {"frames": frames[:, :256]}),
                      device)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               init_s=init_s, warmup_s=warm_s, head_dim=cfg.resolved_head_dim,
               causal=cfg.causal,
               **recorded_prefill(device, cfg, prefill, params,
                                  {"frames": frames}, "lm_frontends_replay"))
    out.update(prefill_main_path(device, cfg, prefill, params, None,
                                 batch={"frames": frames}))
    if device.type == "cuda":
        check(out["k5_launches"] == cfg.n_layers,
              f"K5 launched {out['k5_launches']} times in an encode of "
              f"{cfg.n_layers} layers")
        check(out["k5_kernels"] == ["flash_attention_sm90"],
              f"hubert's K5 launches took {out['k5_kernels']}")
    out["kernel_share_of_prefill"] = (out["k5_launches"] * out["kernel_ms"]
                                      / (out["ttft_s"] * 1e3))
    emit("reduced", lm_arch=cfg.name, f32_check_layers=HUBERT_CHECK_LAYERS,
         of=cfg.n_layers, f32_check_frames=check_frames, why="the float32 "
         "check runs the SIMT kernel and the plain version over every "
         "position of a 30 s clip; three layers of the same weights keep it "
         "to seconds")
    cut = Model(dataclasses.replace(cfg, n_layers=HUBERT_CHECK_LAYERS,
                                    dtype="float32"))
    f32 = frames[:, :check_frames].float()
    from repro_torch.kernels import flash_attention as FA
    with torch.no_grad():
        FA.launches = 0
        x, _ = cut.forward(params, {"frames": f32})
        got = cut.logits(params, x)[0].float()
        launched = FA.launches
        with plain_attention():
            x, _ = cut.forward(params, {"frames": f32})
            want = cut.logits(params, x)[0].float()
    check_row = dict(dtype="float32", frames=check_frames,
                     layers=HUBERT_CHECK_LAYERS, k5_launches=launched,
                     **logit_agreement(want, got))
    emit("lm_frontends_check", **check_row)
    check(check_row["argmax_equal"] and check_row["max_rel_err"] <= 1e-3
          and launched == (HUBERT_CHECK_LAYERS if device.type == "cuda"
                           else 0),
          f"hubert's float32 encode through K5 differs from the plain "
          f"version: {check_row}")
    out["check"] = check_row
    return out


def lm_frontends_vl(device, seed: int, cfg, seq: int, prompt: int,
                    max_new: int) -> dict:
    """qwen2-vl-2b (M-RoPE, GQA group 6, D 128): a bf16 prefill of ``seq``
    tokens with ``VL_PATCHES`` patch embeddings over the first positions
    (its last K5 launch replayed and timed), the main path (one K5 launch a
    layer), the float32 prefill-against-decode check on its tokens, and
    ``ServeEngine`` (token prompts, as the reference's engine takes)."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.models.steps import make_prefill_step
    emit("reduced", lm_arch=cfg.name, lm_prefill_batch=1,
         of=SHAPES["prefill_32k"].global_batch, why="prefill_32k's global "
         "batch of 32 cut to one sequence on one card")
    model, params, n_params, init_s = drawn_model(device, seed, cfg)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen,
                           device=device)
    patches = torch.randn((1, VL_PATCHES, cfg.d_model), generator=gen,
                          device=device).to(torch.bfloat16)
    batch = {"tokens": tokens, "patch_embeds": patches}
    _, warm_s = timed(lambda: prefill(params, {"tokens": tokens[:, :512],
                                               "patch_embeds": patches}),
                      device)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
               init_s=init_s, warmup_s=warm_s, patches=VL_PATCHES,
               **recorded_prefill(device, cfg, prefill, params, batch,
                                  "lm_frontends_replay"))
    out.update(prefill_main_path(device, cfg, prefill, params, tokens,
                                 batch=batch))
    if device.type == "cuda":
        check(out["k5_launches"] == cfg.n_layers
              and out["k5_kernels"] == ["flash_attention_sm90"],
              f"qwen2-vl: {out['k5_launches']} K5 launches on "
              f"{out['k5_kernels']} for {cfg.n_layers} layers")
    out["kernel_share_of_prefill"] = (out["k5_launches"] * out["kernel_ms"]
                                      / (out["ttft_s"] * 1e3))
    out["check"], _ = lm_prefill_check(
        device, dataclasses.replace(cfg, dtype="float32"), params,
        tokens[:, :LM_CHECK_TOKENS], phase="lm_frontends_check")
    out["serve"] = serve_aligned(device, seed, model, params, prompt,
                                 max_new)
    return out


def phase_lm_frontends(device, seed: int, hubert_cfg=None, vl_cfg=None,
                       seq: int = LM_PREFILL_SEQ,
                       check_frames: int = HUBERT_CHECK_FRAMES,
                       prompt: int = 64, max_new: int = 32) -> dict:
    """The frames and patch-embedding frontends at full width and depth,
    one model after the other: hubert-xlarge's encode, then qwen2-vl-2b's
    prefill with patch embeddings and its engine."""
    import torch
    from repro_torch.configs import get_config
    hubert_cfg = hubert_cfg or get_config(HUBERT_ARCH)
    vl_cfg = vl_cfg or get_config(VL_ARCH)
    hu = lm_frontends_hubert(device, seed, hubert_cfg, seq, check_frames)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    vl = lm_frontends_vl(device, seed, vl_cfg, seq, prompt, max_new)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"hubert": hu, "qwen2_vl": vl}
    emit("lm_frontends", **out)
    return out


# ------------------------------------------------------------ training ----

TRAIN_SHAPE = "train_4k"
TRAIN_BATCH = 8                # train_4k's global batch of 256, cut
TRAIN_STEPS = 6                # the first is the warm-up
TRAIN_LR = 3e-4
LAUNCHER_STEPS = 10            # the smoke launcher: a checkpoint every 5
LAUNCHER_EVERY = 5


def train_main_path(device, seed: int, cfg, seq: int, batch: int,
                    steps: int) -> dict:
    """``make_train_step`` on ``cfg`` at full width: ``steps`` steps over
    the packed pipeline's batches (with ``VL_PATCHES`` patch embeddings a
    sample, as ``launch/specs.py`` gives train_4k's vlm batches), K5's
    count set to 0 before each step and read after. The first step is the
    warm-up, and its first K5 launch is kept and replayed through the plain
    version and timed; the last has CUDA events around the plain attention
    backward (``layers.attention.attention_backward``) for its share.
    Then one more step runs through the production layout
    (``layout_train_step``) on the trained state."""
    import torch
    from repro_torch.data.packing import PackedPipeline, SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import Model
    from repro_torch.models.steps import init_train_state, make_train_step
    model = Model(cfg)
    (params, opt), init_s = timed(
        lambda: init_train_state(model, seed, device), device)
    n_params = sum(t.numel() for t in _leaves(params))
    corpus = SyntheticCorpus(n_docs=20_000, vocab=cfg.vocab, seed=seed)
    pipe = PackedPipeline(corpus, seq_len=seq, global_batch=batch)
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    step_fn = make_train_step(model, lr=TRAIN_LR)
    rows, replay = [], None
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch(i).items()}
        if cfg.mrope_sections:
            b["patch_embeds"] = torch.randn(
                (batch, VL_PATCHES, cfg.d_model), generator=gen,
                device=device).to(torch.bfloat16)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        FA.launches = 0
        if i == 0:
            with recorded_attention(keep={0}) as rec:
                (loss, params, opt), sec = timed(
                    lambda: step_fn(params, opt, b), device)
            # the inputs and output as the kernel saw them, off the graph
            n, q, k, v, kw, o = rec.calls[0]
            replay = (n, q.detach(), k.detach(), v.detach(), kw, o.detach())
            del q, k, v, o
            del rec
        elif i == steps - 1:
            with evented_calls(device, "attention",
                               "attention_backward") as ev:
                t0 = ev.mark()
                (loss, params, opt), sec = timed(
                    lambda: step_fn(params, opt, b), device)
                t1 = ev.mark()
                whole = ev.ms(t0, t1)
                bwd = sum(ev.ms(a, c) for a, c in ev.spans)
                n_bwd = len(ev.spans)
        else:
            (loss, params, opt), sec = timed(lambda: step_fn(params, opt, b),
                                             device)
        launches = FA.launches
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        rows.append(dict(step=i, loss=float(loss), seconds=sec,
                         k5_launches=launches, max_memory_allocated=peak))
        emit("lm_train_step", arch=cfg.name, **rows[-1])
        check(bool(np.isfinite(rows[-1]["loss"])),
              f"{cfg.name}: step {i}'s loss is {rows[-1]['loss']}")
        if device.type == "cuda":
            per_pass = cfg.n_layers * (2 if cfg.remat != "none" else 1)
            check(launches == per_pass,
                  f"{cfg.name}: {launches} K5 launches in train step {i}, "
                  f"{per_pass} expected (a forward, and its recompute "
                  "under remat)")
    _, q, k, v, kw, _ = replay
    rep = replay_k5_launch(replay, "lm_train_replay")
    del replay
    times = k5_times(q, k, v, kw, device)
    del q, k, v
    layout_step = layout_train_step(device, model, params, opt, b, TRAIN_LR)
    timed_steps = [r["seconds"] for r in rows[1:]]
    med = float(np.median(timed_steps))
    tokens = seq * batch
    return dict(arch=cfg.name, params=n_params, init_s=init_s, seq=seq,
                batch=batch, remat=cfg.remat, steps=rows,
                warmup_s=rows[0]["seconds"], step_s_median=med,
                tokens_per_s=tokens / med,
                model_tflops_per_step=6 * n_params * tokens / 1e12,
                max_memory_allocated=max(r["max_memory_allocated"] or 0
                                         for r in rows[1:]),
                k5_launches_per_step=rows[-1]["k5_launches"],
                k5_launches=sum(r["k5_launches"] for r in rows),
                attention_backward_calls=n_bwd,
                attention_backward_ms=bwd, evented_step_ms=whole,
                attention_backward_share=bwd / whole,
                layout_step=layout_step,
                **{f"replay_{key}": val for key, val in rep.items()},
                **times)


def launcher_resume(device, seed: int, arch: str = VL_ARCH,
                    steps: int = LAUNCHER_STEPS,
                    every: int = LAUNCHER_EVERY) -> dict:
    """``repro_torch.launch.train`` at ``--smoke`` size on the card,
    deterministic algorithms on: an uninterrupted run of ``steps`` steps,
    and a run stopped after step ``every`` (a checkpoint every ``every``
    steps) then launched again on its directory, which resumes from that
    checkpoint. Its losses and final parameters must equal the
    uninterrupted run's within the reference's tolerances
    (``tests/test_system.py``: 1e-4 relative on the losses, 1e-5 on the
    parameters)."""
    import shutil
    import tempfile
    import warnings
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as T
    from repro_torch.optim.adamw import leaves
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="plex-train-"))

    def args(d):
        return T.parse_args(["--arch", arch, "--smoke", "--steps",
                             str(steps), "--seq", "64", "--batch", "8",
                             "--ckpt-every", str(every), "--ckpt-dir",
                             str(tmp / d), "--device", str(device)])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            FA.launches = 0
            whole, whole_s = timed(lambda: T.train(args("whole")), device)
            launches = FA.launches
            first = T.train(args("cut"), stop_after=every)
            rest = T.train(args("cut"))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})
    resumed = {**first["losses"], **rest["losses"]}
    loss_rel = max(abs(resumed[s] - whole["losses"][s])
                   / max(abs(whole["losses"][s]), 1e-12)
                   for s in whole["losses"])
    param_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(leaves(whole["params"]),
                                    leaves(rest["params"])))
    out = dict(arch=arch, smoke=True, steps=steps, ckpt_every=every,
               first_checkpoints=first["checkpoints"],
               resumed_from=rest["start"] - 1, seconds=whole_s,
               k5_launches=launches, losses=whole["losses"],
               max_loss_rel_err=loss_rel, max_param_abs_err=param_err,
               bit_exact=loss_rel == 0 and param_err == 0,
               nondeterministic_ops=nondet, report=rest["report"])
    emit("lm_train_launcher", **out)
    check(first["checkpoints"] == [0, every] and rest["start"] == every + 1,
          f"the launcher resumed from {rest['start'] - 1}, checkpoints "
          f"{first['checkpoints']}")
    check(loss_rel <= 1e-4 and param_err <= 1e-5,
          f"the resumed run differs from the uninterrupted one: {out}")
    if device.type == "cuda":
        check(launches > 0, "the launcher's training made no K5 launch")
    return out


def phase_lm_train(device, seed: int, cfg=None, seq: int | None = None,
                   batch: int = TRAIN_BATCH, steps: int = TRAIN_STEPS
                   ) -> dict:
    """Training on the card: qwen2-vl-2b at full width and depth through
    ``make_train_step`` (``train_main_path``), then the smoke launcher's
    checkpoint and resume (``launcher_resume``)."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    cfg = cfg or get_config(VL_ARCH)
    shape = SHAPES[TRAIN_SHAPE]
    seq = seq or shape.seq_len
    emit("reduced", lm_arch=cfg.name, train_batch=batch,
         of=shape.global_batch, why=f"{TRAIN_SHAPE}'s global batch of "
         f"{shape.global_batch} cut to {batch} sequences on one card "
         "(float32 params, grads, m and v take 16 B a parameter)")
    out = train_main_path(device, seed, cfg, seq, batch, steps)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["launcher"] = launcher_resume(device, seed)
    emit("lm_train", **out)
    return out


# ----------------------------------------------------------------- main ----

class PhaseClock:
    """Host wall seconds of ``main``'s phases: each call closes the phase
    named and opens the next; ``seconds`` maps the names to their times."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-keys", type=int, default=SERVE_KEYS)
    ap.add_argument("--index-keys", type=int, default=INDEX_KEYS)
    args = ap.parse_args(argv)
    # cuBLAS reads its workspace setting when it first starts; this one is
    # what deterministic algorithms need (the launcher check of lm_train)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # full float32 products everywhere (the f32 checks hold K5 and the
    # decode path against each other, not against TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lap = PhaseClock()
    info = phase_env(device)
    split_lib = phase_build()
    emit("bandwidth", measured_gbs=measure_bandwidth(device),
         published_tbs=PEAK_HBM_TBS, card=info["card"])
    lap("build")
    kern = phase_kernel(device, args.seed, KERNEL_KEYS, QUERIES)
    lap("kernel")
    serve, serve_svc = phase_serve(device, args.seed, args.serve_keys,
                                   QUERIES)
    lap("serve")
    routed = phase_routed(device, args.seed, serve_svc.snapshot, QUERIES)
    del serve_svc
    gc.collect()
    torch.cuda.empty_cache()
    lap("routed")
    phase_merge(device, args.seed, KERNEL_KEYS, QUERIES)
    lap("merge")
    cache, cache_svc, logical = phase_serve_cache(
        device, args.seed, args.serve_keys, QUERIES)
    lap("serve_cache")
    queue = phase_serve_queue(device, args.seed, cache_svc, logical)
    check_healthy(cache_svc, "serve_cache")
    lap("serve_queue")
    observe = phase_observe(device, args.seed, cache_svc, logical, QUERIES)
    lap("observe")
    # the durable phase takes the cached service over and drops it without
    # close, as a crash would
    durable = phase_durable(
        device, args.seed, cache_svc, cache_svc.snapshot.keys, QUERIES,
        partial=lambda gen_dir, keys: routed_partial_load(
            device, gen_dir, keys, QUERIES, args.seed))
    del cache_svc, logical
    gc.collect()
    torch.cuda.empty_cache()
    lap("durable")
    # the routed phase's partial load ran inside durable, on its generation
    lap.seconds["durable"] -= durable["routed_partial_s"]
    lap.seconds["routed_partial_load"] = durable["routed_partial_s"]
    merge_bg = phase_merge_background(device, args.seed, KERNEL_KEYS)
    lap("merge_background")
    chaos = phase_chaos(device, args.seed, CHAOS_KEYS, QUERIES)
    lap("chaos")
    phase_examples(device, info["card"])
    lap("examples")
    index = phase_index(device, args.seed, args.index_keys, QUERIES,
                        split_lib)
    lap("index")
    # the lookup phases' planes are gone with their frames; hand their
    # cached blocks back before the 20 GB model is drawn
    gc.collect()
    torch.cuda.empty_cache()
    emit("memory", allocated=torch.cuda.memory_allocated(device),
         reserved=torch.cuda.memory_reserved(device))
    attn = phase_attention(device, args.seed)
    lap("attention")
    prefill, model, params = phase_lm_prefill(device, args.seed,
                                              LM_PREFILL_SEQ)
    lap("lm_prefill")
    phase_lm_serve(device, args.seed, model, params)
    lap("lm_serve")
    layout_pre = phase_lm_layout_prefill(device, args.seed, model, params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    lap("lm_layout_prefill")
    lm_moe, qwen_cfg, qwen_params = phase_lm_moe(device, args.seed)
    lap("lm_moe")
    par = phase_lm_parallel(device, args.seed, qwen_cfg, qwen_params,
                            info["card"])
    del qwen_params
    gc.collect()
    torch.cuda.empty_cache()
    lap("lm_parallel")
    recurrent = phase_lm_recurrent(device, args.seed)
    lap("lm_recurrent")
    # the MLA, RWKV6 and RG-LRU layouts ran inside lm_moe and lm_recurrent,
    # on the models those phases hold
    families = {"deepseek_v2": lm_moe["deepseek_v2"]["layout"],
                "rwkv6": recurrent["rwkv6"]["layout"],
                "recurrentgemma": recurrent["recurrentgemma"]["layout"]}
    lap.seconds["lm_moe"] -= families["deepseek_v2"]["seconds"]
    lap.seconds["lm_recurrent"] -= (families["rwkv6"]["seconds"]
                                    + families["recurrentgemma"]["seconds"])
    lap.seconds["lm_layout_families"] = sum(f["seconds"]
                                            for f in families.values())
    emit("lm_layout_families", card=info["card"], **{name: {k: f[k] for k in (
        "arch", "n_layers", "seq", "prefill_s", "k5_launches",
        "prefill_equal", "hidden_equal", "logit_rows_equal",
        "decode", "tags", "predicted_peak_bytes", "max_memory_allocated_step",
        "peak_rel_err", "seconds")} for name, f in families.items()})
    frontends = phase_lm_frontends(device, args.seed)
    lap("lm_frontends")
    train = phase_lm_train(device, args.seed)
    lap("lm_train")
    layout = phase_lm_layout(device, info["card"], layout_pre,
                             train["layout_step"], train["seq"],
                             train["batch"])
    lap("lm_layout")
    emit("phase_seconds", **lap.seconds)
    qwen = lm_moe["qwen2_moe"]
    hubert, vl = frontends["hubert"], frontends["qwen2_vl"]
    k5_keys = ("k5_launches", "k5_kernels", "shape", "kernel_ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms", "max_abs_err",
               "replayed_launches")
    csrc = "src/repro_torch/kernels/csrc/"
    k2, k3 = ("src/repro/kernels/plex_segment_lookup.py:302",
              "src/repro/kernels/plex_segment_lookup.py:327")
    k4 = "src/repro/kernels/bounded_search.py:36"
    replaces = {"radix_segment_lookup": k2, "cht_segment_lookup": k3,
                "bounded_search": k4, "window_probe": f"{k2}, {k3}, {k4}"}
    sources = {"radix_segment_lookup": csrc + "segment_lookup.cu",
               "cht_segment_lookup": csrc + "segment_lookup.cu",
               "bounded_search": csrc + "bounded_search.cu",
               "window_probe": csrc + "segment_lookup.cu"}
    summary_keys = ("summary_levels", "summary_bytes",
                    "probe_bytes_per_query", "ms_by_levels")
    # K2/K3 rows: the card's search form, ms by form, the split; the bound
    # leaves out table and cell reads (index_bound_bytes)
    extra = ("card_form", "ms_by_form", "split", "forced_layer", "pair_ms",
             "answer_gather_ms") + summary_keys
    print(json.dumps({"kernels": [{
        "name": "stacked_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stacked_lookup.cu",
        "replaces": "src/repro/kernels/stacked_pallas.py:85",
        "launches": serve["launches"],
        "max_abs_err": max(kern["max_abs_err"], serve["max_abs_err"]),
        "ms": serve["kernel_ms"], "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": "bytes",
        "library_ms": serve["library_ms"], "matches_plain": True,
        "overlapped_launches": serve["overlapped_launches"],
        "ms_no_overlap": serve["ms_no_overlap"],
        "spline_modes": serve["spline_modes"],
        "ms_spline_bisect": serve["ms_spline_bisect"],
        **{k: serve[k] for k in summary_keys},
        "kernel_phase": kern["levels"],
        "past_the_end": kern["past_the_end"],
        # the cached and counted service (serve_cache), the queue and the
        # background merge: their own paths' launches and times
        "cache": {
            "dataset": cache["dataset"], "keys": cache["keys"],
            "slots": CACHE_SLOTS, "theta": ZIPF_THETA,
            "launches": cache["launches"], "ms_cold": cache["ms_cold"],
            "ms_warm": cache["ms_warm"], "ms_off": cache["ms_off"],
            "ms_no_overlap": cache["ms_warm_no_overlap"],
            "hit_rate": cache["hit_rate"],
            "warm_hit_rate": cache["warm_hit_rate"],
            "full_hit_batches": cache["full_hit_batches"],
            "overlap": cache["cached_overlap"],
            "tear_stress_ok": kern["tear_stress_ok"],
            "warm_all_hit": kern["warm_all_hit"]},
        "counted": {"ms": cache["ms_counted"], "ms_off": cache["ms_off"],
                    "live_hotness_ok": cache["live_hotness_ok"],
                    "probe_hist_ok": cache["probe_hist_ok"]},
        "queue": {"launches": queue["launches"],
                  "ticket_p99_ms": queue["ticket_p99_ms"]},
        # the observed service: the same requests off, disarmed, counted
        # and under the armed recorder
        "observe": {"launches": observe["launches"],
                    "launches_per_request": observe["launches_per_request"],
                    "overlapped_per_request":
                        observe["overlapped_per_request"],
                    "counted_launches": observe["counted_launches"],
                    "uncounted_launches": observe["uncounted_launches"],
                    "recorder_over_off": observe["recorder_over_off"]},
        "merge_background": {"launches": merge_bg["launches"],
                             "merges": merge_bg["merges"]},
        # the reopened service (PlexService.open) and the chaos phase
        "durable": {"launches": durable["launches"],
                    "request_ms_first_after_open":
                        durable["first_request_ms"],
                    "kernel_ms_first_request":
                        durable["kernel_ms_first_request"]},
        "chaos": {"launches_before": chaos["k1_launches_before"],
                  "launches_after": chaos["k1_launches_after"],
                  "fallback_lookups": chaos["fallback_lookups"],
                  "torch_over_k1": chaos["torch_over_k1"]},
        # the routed path: the 200M-key snapshot over slots of the card,
        # the partial load over 4 slots, the 4-slot service drill
        "routed": {
            "keys": routed["keys"], "shards": routed["shards"],
            "layer_kinds": routed["layer_kinds"],
            "first_unifying_slots": routed["first_unifying_slots"],
            "slots": {n: {k: v for k, v in r.items()
                          if k not in ("request_ms", "per_shard_request_ms")}
                      for n, r in routed["slots"].items()},
            "partial_load": durable["routed_partial"],
            "service": routed["service"]}}] + [{
        "name": name, "route": "cuda", "source": sources[name],
        "replaces": replaces[name], "launches": k["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": k["library_ms"],
        "matches_plain": True,
        "on_main_path": name == "window_probe",
        **{f: k[f] for f in extra if f in k},
        **({"service_plane": serve["probe_200m"]}
           if name == "bounded_search" else {}),
        **({"reopened_shard_launches": durable["index_launches"]}
           if name == "window_probe" else {})}
        for name, k in index.items()] + [{
        "name": "flash_attention", "route": "cuda",
        "source": csrc + prefill["kernel"] + ".cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": (prefill["launches"] + qwen["k5_launches"]
                     + par["k5_launches"] + hubert["k5_launches"]
                     + vl["k5_launches"] + train["k5_launches"]
                     + layout_pre["k5_launches"]
                     + par["layout"]["k5_launches"]
                     + train["layout_step"]["k5_launches"]),
        "max_abs_err": max(attn["max_abs_err"], prefill["max_abs_err"],
                           qwen["max_abs_err"], par["max_abs_err"],
                           hubert["max_abs_err"],
                           vl["max_abs_err"], train["replay_max_abs_err"],
                           layout_pre["max_abs_err"],
                           par["layout"]["max_abs_err"]),
        "ms": prefill["kernel_ms"], "plain_ms": prefill["plain_ms"],
        "bound_ms": prefill["bound_ms"], "bound_by": prefill["bound_by"],
        "library_ms": prefill["library_ms"], "matches_plain": True,
        # qwen2-moe's prefill (lm_moe) and its expert-parallel prefill
        # over the one-rank mesh (lm_parallel), hubert's encode at D 80 and
        # qwen2-vl's prefill (lm_frontends), qwen2-vl's training forward
        # and its recompute (lm_train): each its launches, at its shape
        "qwen2_moe": {k: qwen[k] for k in k5_keys},
        "qwen2_moe_parallel": {k: par[k] for k in k5_keys + (
            "seq", "ep_all_reduces", "ep_prefill_s", "gspmd_prefill_s")},
        "hubert": {k: hubert[k] for k in k5_keys},
        # the production layout on the one-rank mesh: minitron-4b's and
        # qwen2-moe's prefills (bit for bit the unsharded ones) and a
        # qwen2-vl-2b train step, with the dry run's peaks beside the card's
        "layout": {
            "minitron_prefill": {k: layout_pre[k] for k in (
                "k5_launches", "k5_kernels", "prefill_s", "max_abs_err",
                "replayed_launches")},
            "qwen2_moe_prefill": {k: par["layout"][k] for k in (
                "k5_launches", "k5_kernels", "prefill_s", "max_abs_err")},
            "train_step_k5_launches": train["layout_step"]["k5_launches"],
            "dry_run": {name: {k: layout[name][k] for k in (
                "predicted_peak_bytes", "measured_peak_bytes",
                "peak_rel_err", "flops", "tflops_per_s")}
                for name in ("qwen2_vl_train", "minitron_prefill")}},
        "qwen2_vl": {k: vl[k] for k in k5_keys},
        "train": {"k5_launches": train["k5_launches"],
                  "k5_launches_per_step": train["k5_launches_per_step"],
                  "max_abs_err": train["replay_max_abs_err"],
                  **{k: train[k] for k in (
                      "shape", "kernel_ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")}}}]}),
        flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
