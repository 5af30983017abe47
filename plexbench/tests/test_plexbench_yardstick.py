"""The yardstick alone: the trace's reduction, the roofline's byte count and
the readers, on synthetic inputs."""
import types

import numpy as np
import pytest
import torch

from plexbench import devtrace, harness, roofline


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_busy_gaps_and_names():
    # markers at 1,000 and 2,000 us; the span maps to perf_counter 10-11 s
    ev = [_x(devtrace.MARK, "user_annotation", 1000.0, 1.0),
          _x(devtrace.MARK, "user_annotation", 2000.0, 1.0),
          _x("k1", "kernel", 900.0, 200.0),          # clipped to 1000-1100
          _x("k1", "kernel", 1300.0, 100.0),
          _x("Memcpy HtoD", "gpu_memcpy", 1350.0, 150.0),   # overlaps k1
          _x("k2", "kernel", 1900.0, 300.0),          # clipped to 1900-2000
          _x("aten::copy_", "cpu_op", 1150.0, 100.0),  # in gap 1100-1300
          _x("cudaLaunchKernel", "cuda_runtime", 1690.0, 20.0),
          {"ph": "i", "name": "flow", "ts": 1.0}]
    # a client span covering the second gap (1500-1900), longer than the
    # runtime call inside it, so the call names that gap
    spans = [("client.result", 10.45, 10.95)]
    s = devtrace.reduce_events(ev, 10.0, 11.0, spans)
    assert s.window_s == pytest.approx(1.0)
    assert s.busy_s == pytest.approx((100 + 200 + 100) / 1e6)
    assert s.kernel_s == pytest.approx((100 + 100 + 100) / 1e6)
    ops = dict((k, v) for k, v in s.device_ops)
    assert ops["k1"] == pytest.approx(200e-6)
    assert ops["Memcpy HtoD"] == pytest.approx(150e-6)
    idle = dict((k, v) for k, v in s.idle_gaps)
    assert idle["aten::copy_"] == pytest.approx(200e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(400e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - s.busy_s)


def test_trace_reduction_needs_its_markers():
    with pytest.raises(RuntimeError):
        devtrace.reduce_events([_x("k", "kernel", 0.0, 1.0)], 0.0, 1.0)


def test_lookup_bytes_counts_keys_ranks_and_distinct_sectors():
    keys = np.arange(0, 800, 10, dtype=np.uint64)       # 80 keys, 20 sectors
    q = np.array([0, 5, 10, 795, 1 << 63, 10], dtype=np.uint64)
    # ranks 0, 1, 1 | 80, 80, 1 -> keys at (0), (0, 1) | (79), (0, 1) ->
    # sectors {0} in the first request, {19, 0} in the second
    cpu = torch.device("cpu")
    got = roofline.lookup_bytes(keys, [q[:3], q[3:]], cpu)
    assert got == 6 * 12 + 3 * 32
    # a sector counts once within a request, and again in the next one:
    # the count grows with the requests, not with the span they fall in
    assert roofline.lookup_bytes(keys, [q], cpu) == 6 * 12 + 2 * 32
    assert roofline.lookup_bytes(keys, [q, q], cpu) == 2 * (6 * 12 + 2 * 32)


def test_the_peak_table_names_the_h100():
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert roofline.peak("a card not in the table", "hbm_bytes_per_s") is None


def _requests(rows):
    return np.array(rows, dtype=[("client", np.int32), ("index", np.int64),
                                 ("offset", np.int64), ("size", np.int64),
                                 ("t0", np.float64), ("t1", np.float64),
                                 ("t2", np.float64), ("ok", np.bool_)])


def _reader(name):
    from conftest import ROOT
    return harness.Bench(ROOT).module("metrics", name).read


def test_readers_on_a_synthetic_run():
    reqs = _requests([(0, 0, 0, 100, 0.0, 0.1, 0.5, True),
                      (1, 0, 0, 300, 0.0, 0.3, 0.9, True),
                      (0, 1, 0, 500, 0.5, 0.6, 1.5, True),   # after the close
                      (1, 1, 0, 700, 0.9, 0.9, 0.95, False)])
    run = types.SimpleNamespace(
        requests=reqs, t_end=1.0, seconds=1.0, setup_s=12.5, build_s=8.0,
        ctor_s=10.0, span=None,
        stats0={"cache_hits": 10, "cache_queries": 100, "epoch": 0},
        stats1={"cache_hits": 30, "cache_queries": 300, "epoch": 0})
    assert _reader("lookups_per_s")(run) == 400.0
    assert _reader("setup_s")(run) == 12.5
    assert _reader("build_s")(run) == 8.0
    assert _reader("upload_s")(run) == 2.0
    assert _reader("submit_ms")(run) == pytest.approx(
        np.mean([0.1, 0.3, 0.1, 0.0]) * 1e3)
    assert _reader("request_p95_ms")(run) == pytest.approx(
        np.percentile([500.0, 900.0, 1000.0], 95))
    assert _reader("cache_hit_pct")(run) == pytest.approx(10.0)
    for name in ("device_idle_pct", "lookup_roofline"):
        assert _reader(name)(run) is None
    run.stats1 = dict(run.stats0)
    assert _reader("cache_hit_pct")(run) is None


def test_the_sampler_keeps_a_seeded_uniform_sample():
    def kept(seed):
        s = harness.Sampler(seed, 2, 3)
        for i in range(50):
            for c in range(2):
                s.offer(c, i, i, 1, np.zeros(1))
        return sorted((it[0] for it in s.items()))
    a = kept(5)
    assert a == kept(5) and len(a) == 6
    assert max(a) > 5                  # not the first requests alone
    assert kept(5) != kept(6)
