"""Durable PLEX serving of the port: build -> mutate -> save -> "kill" ->
open -> serve (the port of ``examples/save_open.py``), on the CUDA card
unless ``--device`` says otherwise.

A service is built from raw keys once, takes some inserts and deletes, and
persists itself (snapshot generation + delta WAL + manifest). The process
"restart" is simulated by dropping every in-memory object;
``PlexService.open`` then starts from disk in load time — the snapshot
planes are mapped, no spline scan or auto-tune runs, and the live delta
comes back from the WAL — and keeps serving through K1 (and logging
updates, and rotating generations at merges). The reopened service's ranks
must equal ``np.searchsorted`` over the logical keys and the live answer
before the drop.

    PYTHONPATH=src python -m repro_torch.launch.save_open [--device cpu] \\
        [--n 1000000] [--dir DIR]

``--dir`` (a fresh temporary directory unless given) holds the service, in
its ``service/`` directory.
"""
from __future__ import annotations

import argparse
import pathlib
import shutil
import tempfile
import time

import numpy as np

from ..data import generate
from ..device import resolve_device
from ..serving import PlexService


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--eps", type=int, default=64)
    ap.add_argument("--dataset", default="osm",
                    choices=["amzn", "face", "osm", "wiki"])
    ap.add_argument("--queries", type=int, default=200_000)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.dir if args.dir is not None
                           else tempfile.mkdtemp(prefix="plex-durable-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    root = out_dir / "service"
    shutil.rmtree(root, ignore_errors=True)
    keys = generate(args.dataset, args.n)
    rng = np.random.default_rng(0)

    # ---- process 1: cold build, some updates, save --------------------
    t0 = time.perf_counter()
    svc = PlexService(keys.copy(), eps=args.eps, device=device)
    build_wall = time.perf_counter() - t0
    svc.insert(rng.integers(keys[0], keys[-1], 2_000, dtype=np.uint64))
    svc.delete(keys[rng.integers(0, keys.size, 500)])
    model = svc.logical_keys().copy()
    q = model[rng.integers(0, model.size, args.queries)]
    live = svc.lookup(q)
    svc.save(root)
    print(f"built {args.n:,} keys in {build_wall:.2f}s, "
          f"{svc.n_pending} delta entries pending; saved generation "
          f"{svc.generation} -> {root}")
    svc.close()
    del svc                                     # the "kill"

    # ---- process 2: warm start from disk ------------------------------
    svc = PlexService.open(root, device=device)  # manifest -> snapshot + WAL
    print(f"reopened in {svc.load_s*1e3:.1f}ms "
          f"({build_wall / svc.load_s:.0f}x faster than the build); "
          f"{svc.n_pending} delta entries replayed from the WAL")

    t0 = time.perf_counter()
    got = svc.lookup(q)                         # K1 on the card
    first = time.perf_counter() - t0
    assert np.array_equal(got, np.searchsorted(model, q, side="left"))
    assert np.array_equal(got, live)
    print(f"first post-open batch: {first*1e3:.1f}ms "
          f"(kernel load + dispatch); merged lookups verified")

    # updates keep flowing to the recovered WAL; a merge rotates the
    # on-disk generation before the in-memory swap (crash-safe)
    svc.insert(rng.integers(keys[0], keys[-1], 1_000, dtype=np.uint64))
    svc.merge()
    print(f"after merge: durable generation {svc.generation}, "
          f"epoch {svc.epoch}, {svc.n_keys:,} logical keys")
    svc.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
