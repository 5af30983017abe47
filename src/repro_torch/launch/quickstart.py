"""PLEX quickstart of the port: one hyperparameter, build, auto-tune,
batched lookups (the port of ``examples/quickstart.py``), on the CUDA card
unless ``--device`` says otherwise.

Builds one PLEX on the host, prints its auto-tuned layer, its build phases
and its size, answers the queries with the host ``PLEX.lookup`` and then
with ``DevicePlex``: one fused ``window_probe`` launch a lookup on the card
(K2/K3 fused with K4's probe; its plain version on the CPU). Both answers
must equal ``np.searchsorted``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] \\
        [--n 1000000] [--eps 32] [--dataset osm] [--queries 500000]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import build_plex
from ..data import generate
from ..device import resolve_device
from ..kernels import DevicePlex


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--eps", type=int, default=32)
    ap.add_argument("--dataset", default="osm",
                    choices=["amzn", "face", "osm", "wiki"])
    ap.add_argument("--queries", type=int, default=500_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    keys = generate(args.dataset, args.n)
    print(f"dataset={args.dataset} n={args.n} eps={args.eps} "
          f"device={device}")

    px = build_plex(keys, eps=args.eps)      # <- the ONLY hyperparameter
    t = px.tuning
    print(f"build: {px.stats.total_s:.2f}s (spline {px.stats.spline_s:.2f}s, "
          f"auto-tune {px.stats.tune_s:.2f}s, layer {px.stats.layer_s:.2f}s)")
    print(f"auto-tuned radix layer: {t.kind} r={t.r} delta={t.delta} "
          f"predicted-steps={t.predicted_lambda:.2f}")
    print(f"size: spline {px.spline.size_bytes/1024:.1f} KiB + layer "
          f"{px.layer.size_bytes/1024:.1f} KiB "
          f"(<= 2x spline, paper guarantee)")

    rng = np.random.default_rng(0)
    q = keys[rng.integers(0, keys.size, args.queries)]
    want = np.searchsorted(keys, q, side="left")
    t0 = time.perf_counter()
    idx = px.lookup(q)
    dt = time.perf_counter() - t0
    assert np.array_equal(idx, want)
    print(f"numpy batched lookup: {dt/q.size*1e9:.0f} ns/key (exact)")

    dp = DevicePlex.from_plex(px, device=device)
    small = q[:8192]
    # the first lookup builds and loads the kernel on a card
    assert np.array_equal(dp.lookup(small), want[:8192])
    t0 = time.perf_counter()
    got = dp.lookup(q)                       # one window_probe launch
    dt = time.perf_counter() - t0
    assert np.array_equal(got, want)
    print(f"device lookup: mode={dp.planes.static['mode']} "
          f"window={dp.planes.window}, {q.size:,} queries in one launch, "
          f"{dt/q.size*1e9:.1f} ns/key with the copies (exact)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
