"""Routed PLEX serving of the port: build -> plan -> partial-load -> serve
-> merge (the port of ``examples/mesh_serve.py``), on the CUDA card unless
``--device`` says otherwise.

The reference carves its host platform into 8 XLA devices; the port's
counterpart is ``--slots`` slots of the one device (``devices=[device] *
N``), each its own partition and, on a card, its own CUDA stream:

1. build a sharded snapshot through a planned ``PlexService`` and persist
   it as a generation,
2. plan placement straight from the on-disk header (``plan_from_dir``:
   per-shard key counts and plane sizes; no bulk bytes read),
3. partial-load each slot's shard range (``open_routed``: every slot maps
   *only* the plane byte ranges its plan assigns it) and look up through
   the routed lookup, K1 on every slot,
4. serve through the planned service (insert/delete/merge work unchanged;
   a merge re-plans the new snapshot).

    PYTHONPATH=src python -m repro_torch.launch.mesh_serve [--device cpu] \\
        [--n 2000000] [--slots 8] [--devices N] [--shards 8] [--dir DIR]

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
from ..distrib import open_routed, plan_from_dir
from ..persist import gen_name, load_snapshot
from ..serving import PlexService


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--eps", type=int, default=64)
    ap.add_argument("--dataset", default="osm",
                    choices=["amzn", "face", "osm", "wiki"])
    ap.add_argument("--slots", type=int, default=8,
                    help="slots of the device (the reference's forced "
                         "host device count)")
    ap.add_argument("--devices", type=int, default=None,
                    help="plan span (default: all slots)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--queries", type=int, default=200_000)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    devs = [device] * args.slots
    n_dev = args.devices or len(devs)
    print(f"{device}: {len(devs)} slots; planning over {n_dev}")

    out_dir = pathlib.Path(args.dir if args.dir is not None
                           else tempfile.mkdtemp(prefix="plex-mesh-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    root = out_dir / "service"
    shutil.rmtree(root, ignore_errors=True)
    keys = generate(args.dataset, args.n)
    rng = np.random.default_rng(0)

    # ---- build + persist a sharded snapshot ---------------------------
    svc = PlexService(keys.copy(), eps=args.eps, n_shards=args.shards,
                      plan=n_dev, devices=devs, device=device)
    svc.save(root, fsync=False)
    print(f"built {svc.n_shards} shards over {args.n:,} keys in "
          f"{svc.build_s:.2f}s; persisted generation {svc.generation}")
    assert svc.plan is not None, "the slots' shards did not unify"
    print("placement plan:")
    print(svc.plan.describe())

    # ---- plan + partial-load per slot (the multi-host story) ----------
    # a real deployment runs this per host: plan from the header, then map
    # only the byte ranges this host's devices serve
    gen_dir = root / gen_name(svc.generation)
    plan = plan_from_dir(gen_dir, n_dev)
    full_bytes = load_snapshot(gen_dir, device=device).mapped_bytes
    router, snaps, mapped = open_routed(gen_dir, plan, devs, block=svc.block)
    per_dev = [f"slot{int(d)}: {s.mapped_bytes:,}B"
               for d, s in zip(plan.active, snaps)]
    print(f"partial loads: {', '.join(per_dev)}")
    print(f"  total mapped {mapped:,}B across {plan.n_active} slots "
          f"(full load maps {full_bytes:,}B on EVERY host)")
    q = keys[rng.integers(0, keys.size, args.queries)]
    t0 = time.perf_counter()
    out, batch = router.lookup(q)
    dt = time.perf_counter() - t0
    assert np.array_equal(out, np.searchsorted(keys, q, "left"))
    print(f"routed lookup: {q.size:,} queries, {batch.n_batches} "
          f"micro-batches, {dt / q.size * 1e9:.0f} ns/lookup (cold)")
    del router, snaps

    # ---- serve + update through the planned service -------------------
    svc.warmup()
    backend = svc.default_backend
    ns = svc.throughput(q, backends=(backend,), repeats=3)[backend]
    print(f"planned service throughput: {ns:.0f} ns/lookup ({backend})")
    ins = rng.integers(keys[0], keys[-1], 2_000, dtype=np.uint64)
    dels = np.unique(keys[rng.integers(0, keys.size, 1_000)])
    svc.insert(ins)
    svc.delete(dels)
    logical = svc.logical_keys()
    n_check = min(50_000, q.size)
    got = svc.lookup(q[:n_check])
    assert np.array_equal(got, np.searchsorted(logical, q[:n_check], "left"))
    print(f"merged lookups exact with {svc.n_pending} pending delta entries")

    t0 = time.perf_counter()
    svc.merge()
    print(f"merge + re-plan + re-partition in {time.perf_counter() - t0:.2f}s"
          f" (epoch {svc.epoch}, generation {svc.generation})")
    print("post-merge plan:")
    print(svc.plan.describe())
    got = svc.lookup(q[:n_check])
    assert np.array_equal(got, np.searchsorted(svc.keys, q[:n_check], "left"))
    print("post-merge routed lookups exact; done")
    svc.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
