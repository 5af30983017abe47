"""End-to-end observability drill of the port: serve a workload, dump the
telemetry (the port of ``examples/observe.py``), on the CUDA card unless
``--device`` says otherwise.

Drives one durable ``PlexService`` through the observed lifecycle —
build, ``save``/``open`` (WAL and persist spans), synchronous lookups,
``submit``/``drain`` queue formation, inserts past the merge threshold
(merge spans and the epoch rollover) — with ``obs`` armed, then writes the
observation out:

* a JSONL event log (``--jsonl-out``): every pipeline span plus one final
  registry-snapshot line,
* a Prometheus text-format scrape (``--prom-out``),
* the ``health()`` JSON with its ``metrics`` section (``--health-out``).

Along the way it asserts the observability contract:

1. at least 6 distinct pipeline-stage span names were recorded,
2. the live ``shard_hotness`` estimate equals an exact
   ``np.bincount(svc.route(stream))`` over the post-merge served stream,
3. the probe-trip histogram total equals the counted query count,
4. p50/p99 lookup latency is present in both the registry snapshot and
   ``health()["metrics"]``,
5. the disabled-hook overhead stays under 2% of an un-instrumented
   uniform lookup (measured hook cost x hook sites per call against the
   measured obs-off ns/lookup),
6. the armed flight recorder (metrics, 1-in-8 span sampling and the
   background series sampler; K1's uncounted variant serves) keeps
   uniform serve within ``RECORDER_OVERHEAD_BUDGET`` of the obs-off
   baseline (the median, over ``REPEATS`` turns, of an armed lookup's time
   over the obs-off lookup beside it, the armed one first in every other
   turn: adjacent lookups share the host's load, so the ratio holds on a
   busy host too; on the CPU both are timed on the process's CPU clock,
   which the other processes of a shared host do not advance), and one
   sampler tick costs under ``TICK_DUTY_BUDGET`` of its wake interval (the
   median tick of those turns).

    PYTHONPATH=src python -m repro_torch.launch.observe [--device cpu] \\
        [--n 200000] [--queries 100000] [--dir DIR] \\
        [--jsonl-out obs-events.jsonl] [--prom-out obs-metrics.prom] \\
        [--health-out obs-health.json]

The outputs default to files in ``--dir`` (a fresh temporary directory
unless given), which also holds the service's generations.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile
import time

import numpy as np

from ..data import generate
from ..device import resolve_device
from ..obs import (METRICS, RECORDER, TRACE, disable_observability,
                   enable_observability)
from ..obs.export import write_jsonl, write_prometheus
from ..serving import PlexService

# hook sites a single un-instrumented lookup() walks: the enabled-check in
# lookup, one TRACE.span return per pipeline stage (staging, dispatch,
# sync), the counted-dispatch guards and the fold guard — generously
# rounded up
HOOKS_PER_LOOKUP = 8
OVERHEAD_BUDGET = 0.02
# always-on posture: armed sampled serve against obs-off (see assertion 6;
# the bound carries slack above the expected cost of a few %), and a
# sampler tick as a fraction of its wake interval
SPAN_SAMPLE = 8
RECORDER_OVERHEAD_BUDGET = 0.10
TICK_DUTY_BUDGET = 0.10
REPEATS = 31


def measure_disabled_hook_ns(iters: int = 200_000) -> float:
    """Measured cost of one disabled hook site (attribute read + null
    span), in ns."""
    assert not TRACE.enabled and not METRICS.enabled
    t0 = time.perf_counter()
    for _ in range(iters):
        with TRACE.span("x"):
            pass
        if METRICS.enabled:          # pragma: no cover - disabled
            METRICS.counter("x").inc()
    return (time.perf_counter() - t0) / iters * 1e9 / 2  # 2 sites per iter


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=100_000)
    ap.add_argument("--eps", type=int, default=64)
    ap.add_argument("--n-shards", type=int, default=4)
    ap.add_argument("--dataset", default="osm",
                    choices=["amzn", "face", "osm", "wiki"])
    ap.add_argument("--dir", default=None)
    ap.add_argument("--jsonl-out", default=None)
    ap.add_argument("--prom-out", default=None)
    ap.add_argument("--health-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.dir if args.dir is not None
                           else tempfile.mkdtemp(prefix="plex-observe-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    root = out_dir / "service"
    shutil.rmtree(root, ignore_errors=True)
    jsonl_out = args.jsonl_out or out_dir / "obs-events.jsonl"
    prom_out = args.prom_out or out_dir / "obs-metrics.prom"
    health_out = pathlib.Path(args.health_out or
                              out_dir / "obs-health.json")

    rng = np.random.default_rng(9)
    keys = generate(args.dataset, args.n, seed=1)
    result = {"device": str(device)}

    # -- obs-off baseline: un-instrumented uniform serve ---------------------
    disable_observability()
    svc = PlexService(keys, eps=args.eps, n_shards=args.n_shards,
                      device=device)
    q = keys[rng.integers(0, keys.size, args.queries)]
    backend = svc.default_backend
    ns_off = svc.throughput(q, backends=(backend,), repeats=3)[backend]
    print(f"obs-off uniform serve: {ns_off:.1f} ns/lookup")

    # the recorder's clock: on the CPU every step of a lookup is this
    # process's own CPU work, and its CPU time (the sampler thread's
    # included) does not count the slices the scheduler gives other
    # processes on a shared host; on the card, wall time, which holds the
    # wait for the device
    clock = time.process_time if device.type == "cpu" else time.perf_counter

    def ns_per_lookup(timer=time.perf_counter) -> float:
        t0 = timer()
        svc.lookup(q)
        svc.drain()
        return (timer() - t0) / q.size * 1e9

    # disabled-hook overhead bound (assertion 5): the per-call hook cost
    # amortised over a block of keys must stay under the budget
    hook_ns = measure_disabled_hook_ns()
    per_key = HOOKS_PER_LOOKUP * hook_ns / svc.block
    frac = per_key / ns_off
    print(f"disabled hook: {hook_ns:.1f} ns/site -> {per_key:.4f} ns/key "
          f"over block={svc.block} ({frac * 100:.4f}% of obs-off serve)")
    assert frac < OVERHEAD_BUDGET, (
        f"disabled-observability overhead {frac:.4%} exceeds "
        f"{OVERHEAD_BUDGET:.0%} of uniform serve")

    # -- always-on flight recorder (assertion 6) -----------------------------
    # same service, same query stream (warm): an obs-off lookup and one
    # with the production posture armed, in turns, the armed one first in
    # every other turn so neither mode always follows the other
    def armed_lookup() -> float:
        RECORDER.arm(interval_s=0.25, span_sample=SPAN_SAMPLE)
        try:
            ns = ns_per_lookup(clock)
            RECORDER.tick()          # one measured sampler pass
            ticks.append(RECORDER.last_tick_s / RECORDER.interval_s)
        finally:
            RECORDER.disarm()
        return ns

    ratios, ticks = [], []
    ns_rec = best_off = float("inf")
    for turn in range(REPEATS):
        if turn % 2:
            armed = armed_lookup()
            off = ns_per_lookup(clock)
        else:
            off = ns_per_lookup(clock)
            armed = armed_lookup()
        ratios.append(armed / off)
        best_off, ns_rec = min(best_off, off), min(ns_rec, armed)
    ratio = float(np.median(ratios))
    tick_frac = float(np.median(ticks))
    print(f"recorder-armed uniform serve: {ns_rec:.1f} ns/lookup at best "
          f"against {best_off:.1f} off, on the {clock.__name__} clock "
          f"(median {ratio:.3f}x of obs-off, sample_n={SPAN_SAMPLE}); sampler "
          f"tick {RECORDER.last_tick_s * 1e3:.2f} ms ({tick_frac * 100:.2f}%"
          f" of its {RECORDER.interval_s:.2f}s interval)")
    assert ratio < 1.0 + RECORDER_OVERHEAD_BUDGET, (
        f"armed flight recorder costs {(ratio - 1) * 100:.1f}% of uniform "
        f"serve, budget {RECORDER_OVERHEAD_BUDGET:.0%}")
    assert tick_frac < TICK_DUTY_BUDGET, (
        f"sampler tick duty cycle {tick_frac:.2%} exceeds "
        f"{TICK_DUTY_BUDGET:.0%} of the wake interval")
    result.update(ns_off=ns_off, hook_ns=hook_ns, hook_frac=frac,
                  ns_recorder=ns_rec, recorder_ratio=ratio,
                  tick_frac=tick_frac)
    RECORDER.clear()
    METRICS.reset()
    TRACE.clear()

    svc.save(root)
    svc.close()

    # -- observed run --------------------------------------------------------
    enable_observability()
    TRACE.clear()
    METRICS.reset()
    svc = PlexService.open(root, merge_threshold=4096,
                           n_shards=args.n_shards, device=device)
    try:
        # pre-merge traffic: sync lookups + the submit/drain queue path
        warm = keys[rng.integers(0, keys.size, args.queries // 2)]
        svc.lookup(warm)
        t = svc.submit(warm[:10_000])
        svc.drain()
        np.testing.assert_array_equal(
            t.result(), np.searchsorted(keys, warm[:10_000]))

        # inserts past the threshold: WAL appends + one merge cycle
        fresh = np.unique(rng.integers(0, np.uint64(2) ** np.uint64(62),
                                       5000, dtype=np.uint64))
        svc.insert(fresh)
        model = svc.logical_keys()

        # the post-merge served stream (live hotness is per-epoch, so only
        # post-merge traffic counts)
        stream = np.asarray(model)[rng.integers(0, model.size,
                                                args.queries)]
        got = svc.lookup(stream)
        np.testing.assert_array_equal(
            got, np.searchsorted(model, stream, side="left"))

        ns_on = svc.throughput(stream[:args.queries // 2],
                               backends=(backend,), repeats=3)[backend]
        print(f"obs-on  uniform serve: {ns_on:.1f} ns/lookup "
              f"({ns_on / ns_off:.2f}x of obs-off; armed cost is opt-in)")

        # -- assertions ------------------------------------------------------
        names = TRACE.span_names()
        stage_names = sorted(n for n in names
                             if n.split(".")[0] in
                             ("serve", "merge", "wal", "persist", "build"))
        print(f"pipeline span names ({len(stage_names)}): "
              f"{', '.join(stage_names)}")
        assert len(stage_names) >= 6, stage_names

        hot = svc.live_hotness()
        h = METRICS.histogram("serve.lookup_ns_per_key")
        assert h.count > 0 and h.percentile(0.99) > 0
        hm = svc.health()["metrics"]
        reg = hm["registry"]
        p50 = reg["histograms"]["serve.lookup_ns_per_key"]["p50"]
        p99 = reg["histograms"]["serve.lookup_ns_per_key"]["p99"]
        print(f"lookup latency: p50={p50:.1f} p99={p99:.1f} ns/key")
        assert p50 > 0 and p99 >= p50

        assert hm["shard_hotness"] == [int(x) for x in hot]
        probe = svc.probe_trip_hist()
        assert probe.sum() == hot.sum(), (probe.sum(), hot.sum())
        print(f"live hotness (per-epoch): {hot.tolist()} "
              f"(total {int(hot.sum())}); probe trips total "
              f"{int(probe.sum())}")

        # exactness of the live estimate: one more measured stream, folded
        # from a known zero point
        base = svc.live_hotness()
        check = np.asarray(model)[rng.integers(0, model.size,
                                               args.queries // 3)]
        svc.lookup(check)
        grew = svc.live_hotness() - base
        want = np.bincount(svc.route(check), minlength=svc.n_shards)
        assert np.array_equal(grew, want), (grew, want)
        print("live hotness == np.bincount(svc.route(stream)) exactly")

        # -- exports ---------------------------------------------------------
        disable_observability()
        jl = write_jsonl(jsonl_out)
        pm = write_prometheus(prom_out)
        health_out.write_text(json.dumps(svc.health(), indent=2,
                                         sort_keys=True))
        n_spans = sum(1 for _ in open(jl)) - 1
        print(f"wrote {jl} ({n_spans} spans), {pm}, {health_out}")
        result.update(ns_on=ns_on, span_names=stage_names, spans=n_spans,
                      p50_ns_per_key=p50, p99_ns_per_key=p99,
                      jsonl=str(jl), prom=str(pm), health=str(health_out))
    finally:
        svc.close()
        disable_observability()
    print("observe drill OK")
    return result


if __name__ == "__main__":
    main()
