"""Chaos drill of the port: fault-inject a live service end to end, record
``health()`` (the port of ``examples/chaos_drill.py``), on the CUDA card
unless ``--device`` says otherwise.

Walks one durable ``PlexService`` through the rainy-day repertoire and
verifies at every step that degraded serving stays *exact* (equal to
``np.searchsorted`` over the logical keys). The service asks for the
fallback chain explicitly (``fallback="auto"``: ``cuda`` -> ``torch`` ->
``numpy``); on the card a service left at its default has none and raises.

1. backend outage  — an always-failing ``cuda`` dispatch fault opens the
   ``cuda`` circuit breaker; lookups degrade down the chain with identical
   answers.
2. merge failure   — a snapshot-rebuild fault is contained: the live
   (snapshot, delta, router) state keeps serving bit-identically.
3. commit failure  — a manifest-rename fault aborts the durable commit
   with the directory swept back to the committed state; the clean retry
   commits.
4. crash + corruption recovery — the newest generation's snapshot is
   destroyed on disk; ``open()`` quarantines it and falls back to the
   retained last-known-good generation, replaying its WAL.

``health()`` snapshots are collected after each phase and written as JSON
(``--health-out``). The drill runs with the flight recorder armed and an
``IncidentManager`` installed on ``--incident-dir``; at the end it asserts
that every drilled failure class (breaker open, merge build fault, manifest
commit fault, corruption quarantine) produced exactly one debounced bundle,
that phase 3's repeated ``merge.failure`` was debounced, and that every
bundle's files parse.

    PYTHONPATH=src python -m repro_torch.launch.chaos_drill [--device cpu] \\
        [--n 200000] [--dir DIR] [--health-out chaos-health.json] \\
        [--incident-dir incidents]

The service, the health log and the bundles go under ``--dir`` (a fresh
temporary directory unless given) unless their own options name a path.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import shutil
import tempfile

import numpy as np

from ..data import generate
from ..device import resolve_device
from ..obs import RECORDER
from ..obs import incident as incidents
from ..persist import gen_name
from ..resilience import (FAULTS, POINT_BACKEND_DISPATCH,
                          POINT_MANIFEST_COMMIT, POINT_MERGE_BUILD, always,
                          fail_once)
from ..serving import PlexService

# one bundle per drilled failure class
EXPECTED_BUNDLES = {
    "breaker.open": 1,             # phase 1: the cuda outage opens the breaker
    "merge.failure": 1,            # phase 2 (phase 3's repeat is debounced)
    "manifest.commit_failed": 1,   # phase 3: atomic commit aborted
    "generation.quarantine": 1,    # phase 4: corrupt snapshot quarantined
}
# the chain the drill asks for (the card's default is none)
FALLBACK = "auto"


def check_exact(svc, model, rng, label):
    q = model[rng.integers(0, model.size, 50_000)]
    got = svc.lookup(q)
    want = np.searchsorted(model, q, side="left")
    assert np.array_equal(got, want), f"{label}: degraded lookup diverged"
    print(f"  [{label}] 50k lookups exact "
          f"(fallbacks so far: {svc.stats.fallback_lookups})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--eps", type=int, default=64)
    ap.add_argument("--dataset", default="osm",
                    choices=["amzn", "face", "osm", "wiki"])
    ap.add_argument("--dir", default=None)
    ap.add_argument("--health-out", default=None)
    ap.add_argument("--incident-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.dir if args.dir is not None
                           else tempfile.mkdtemp(prefix="plex-chaos-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    root = out_dir / "service"
    shutil.rmtree(root, ignore_errors=True)
    idir = pathlib.Path(args.incident_dir or out_dir / "incidents")
    shutil.rmtree(idir, ignore_errors=True)
    health_out = pathlib.Path(args.health_out or
                              out_dir / "chaos-health.json")
    rng = np.random.default_rng(0)
    keys = generate(args.dataset, args.n)
    phases: dict[str, dict] = {}

    # production observability posture: flight recorder armed for the
    # whole drill, incident manager catching every failure class. The
    # debounce window spans the drill on purpose — phase 3's merge
    # failure must collapse into phase 2's bundle, not duplicate it.
    RECORDER.arm(interval_s=0.2)
    mgr = incidents.install(idir, debounce_s=300.0, retention=16)
    try:
        # merge_threshold=0: merges are explicit, so each phase controls
        # exactly when the build/commit under test runs
        svc = PlexService(keys.copy(), eps=args.eps, breaker_threshold=2,
                          keep_generations=2, merge_threshold=0,
                          fallback=FALLBACK, device=device)
        mgr.bind_health(svc.health)
        svc.save(root, fsync=False)
        model = svc.logical_keys().copy()

        # ---- 1: backend outage -> breaker opens -> the chain serves ----
        print("phase 1: cuda dispatch outage")
        FAULTS.inject(POINT_BACKEND_DISPATCH, always(backend="cuda"))
        try:
            check_exact(svc, model, rng, "outage")
            check_exact(svc, model, rng, "outage")  # 2nd failure opens it
            assert svc.health()["degraded"], "breaker should be open"
        finally:
            FAULTS.clear(POINT_BACKEND_DISPATCH)
        phases["backend_outage"] = svc.health()

        # ---- 2: merge failure is contained ----------------------------
        print("phase 2: mid-merge build failure")
        svc.insert(rng.integers(keys[0], keys[-1], 5_000, dtype=np.uint64))
        model = svc.logical_keys().copy()
        with FAULTS.injected(POINT_MERGE_BUILD, fail_once()):
            try:
                svc.merge()
            except Exception as e:
                print(f"  merge contained: {type(e).__name__}")
        check_exact(svc, model, rng, "post-merge-fault")
        phases["merge_failure"] = svc.health()

        # ---- 3: durable commit failure aborts cleanly ------------------
        print("phase 3: manifest commit failure")
        with FAULTS.injected(POINT_MANIFEST_COMMIT, fail_once()):
            try:
                svc.merge()
            except Exception as e:
                print(f"  commit aborted: {type(e).__name__} "
                      f"(still generation {svc.generation})")
        assert svc.merge(), "clean retry must commit"
        print(f"  clean retry committed generation {svc.generation}")
        check_exact(svc, model, rng, "post-commit")
        phases["commit_failure"] = svc.health()
        gen_now = svc.generation
        svc.close()

        # ---- 4: corruption -> last-known-good recovery -----------------
        print("phase 4: newest generation corrupted on disk")
        (root / gen_name(gen_now) / "snapshot.plex").write_bytes(b"garbage")
        svc = PlexService.open(root, fsync=False, fallback=FALLBACK,
                               device=device)
        mgr.bind_health(svc.health)    # the old instance's health is stale
        print(f"  recovered at generation {svc.generation} "
              f"(quarantined {gen_name(gen_now)}); "
              f"{svc.n_pending} WAL entries replayed")
        check_exact(svc, np.asarray(svc.logical_keys()), rng, "recovered")
        phases["lkg_recovery"] = svc.health()
        svc.close()
    finally:
        FAULTS.reset()
        RECORDER.disarm()
        incidents.uninstall()

    # ---- incident-bundle contract --------------------------------------
    bundles = mgr.bundles()
    kinds = collections.Counter(
        json.loads((b / "incident.json").read_text())["kind"]
        for b in bundles)
    assert dict(kinds) == EXPECTED_BUNDLES, (
        f"bundle classes diverged: got {dict(kinds)}, "
        f"want {EXPECTED_BUNDLES}")
    assert mgr.debounced.get("merge.failure", 0) >= 1, (
        "phase 3's merge failure should have been debounced into "
        "phase 2's bundle")
    for b in bundles:
        json.loads((b / "health.json").read_text())
        m = json.loads((b / "metrics.json").read_text())
        assert "registry" in m and "recorder" in m
        for line in (b / "spans.jsonl").read_text().splitlines():
            if line:
                json.loads(line)
        assert (b / "metrics.prom").exists()
    print(f"incident bundles OK: "
          f"{', '.join(b.name for b in bundles)} under {idir}/ "
          f"(debounced: {dict(mgr.debounced)})")

    health_out.write_text(json.dumps(phases, indent=1))
    print(f"drill complete; health snapshots -> {health_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
