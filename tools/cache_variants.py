#!/usr/bin/env python3
"""K1's hot-key cache as served, against candidate designs, on one CUDA card.

    python3 tools/cache_variants.py [--seed 0] [--keys 16000000]
                                    [--parent DIR]

Builds K1 (``src/repro_torch/kernels/csrc/stacked_lookup.cu``) as served and
in candidate forms, each its own library made from the source with one text
change (checked to apply), into ``build/repro_torch_kernels/cache_variants``:

* ``write_all``: every lane writes its key and rank through, a hit too
  (the served kernel writes only on a miss);
* ``no_wait``: no ``griddepcontrol.wait`` before the probe, so an overlapped
  launch may read slots its predecessor has not written yet (fewer hits,
  the same ranks).

Each is timed with CUDA events (``chip_smoke.device_ms``) on a fused, cached
``StackedTorchPlex`` (2^20 slots, ``block`` 65,536) over ``--keys`` keys of
``osm`` and of ``amzn``: one dispatch of 2^20 Zipf(1.2) queries (16
launches) warm (the same queries again), cold (the slots emptied first) and
with the cache detached, in turns (forward, then backward); the served
design also replayed with no launch overlapping its predecessor (the
dispatch's launches made one by one with ``overlap=False``). Every
variant's ranks equal
``np.searchsorted``. With ``--parent`` (another checkout, such as the parent
commit unpacked by ``git archive``), the uncached K1 of that tree and of
this one are timed in turns (parent, this, this, parent), each in a process
of its own: one launch of 2^20 queries over 16M ``amzn`` keys in two
shards, spline count and bisect, with and without a delta. Prints one JSON
line per measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS = 1 << 20
BLOCK = 65536
WAIT = '''      // the launch this one overlaps writes slots: wait for it first
      asm volatile("griddepcontrol.wait;" ::: "memory");
'''
WRITE = '''    if (p.cache && !hit)  // write-through: the key and its rank, one store
'''
CHANGES = {"write_all": [(WRITE, "    if (p.cache)\n")],
           "no_wait": [(WAIT, "")]}

# the uncached K1 of one checkout (run with that checkout as the working
# directory); both trees have these entry points
TIMING = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.core import build_plex, shard_offsets
from repro_torch.data import generate
from repro_torch.kernels import _build
from repro_torch.kernels import stacked_lookup as SL
from repro_torch.kernels.keys import to_biased
from repro_torch.kernels.planes import build_stacked_planes
from repro_torch.serving.delta import DeltaBuffer
seed = int(sys.argv[1])
d = torch.device("cuda", 0)
torch.cuda.set_device(d)
_build.build_all()
rng = np.random.default_rng(seed)
keys = generate("amzn", 16_000_000, seed)
offs = shard_offsets(keys, 2)
ends = np.append(offs[1:], keys.size)
sp = build_stacked_planes([build_plex(keys[lo:hi], 64)
                           for lo, hi in zip(offs, ends)], offs, d)
buf = DeltaBuffer(keys, capacity=4096)
buf.insert(rng.integers(keys[0], keys[-1], 3000, dtype=np.uint64))
delta = buf.device_view(d)
q = torch.from_numpy(to_biased(cs.make_queries(keys, 1 << 20, rng))).to(d)
out = {}
for mode in ("count", "bisect"):
    sp.static["mode"] = mode
    for name, dp in (("cap0", None), ("delta", delta)):
        out[f"{mode}_{name}"] = cs.device_ms(
            lambda: SL.stacked_lookup(sp, "bisect", q, dp), d, reps=20)
print("TIMING " + json.dumps(out), flush=True)
'''


def build() -> dict:
    """The served library and each candidate's, built at once."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "stacked_lookup.cu").read_text()
    out = _build.build_root() / "cache_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in [("served", [])] + list(CHANGES.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old.strip()!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}: {log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (args, res) in _build._SIGNATURES["stacked_lookup"].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs[name] = lib
    return libs


def time_variants(libs: dict, dataset: str, n_keys: int, seed: int,
                  device) -> dict:
    """Warm, cold and uncached ms of one 2^20-query dispatch for each
    library, in turns, and the warm pass's hits."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.index import Snapshot
    from repro_torch.data import generate
    from repro_torch.kernels import stacked_lookup as SL
    from repro_torch.kernels.keys import to_biased
    keys = generate(dataset, n_keys, seed)
    snap = Snapshot.build(keys, 64, device=device)
    st = snap.stacked_impl(block=BLOCK, cache_slots=SLOTS)
    if st is None:
        raise RuntimeError(f"{dataset}: the shards do not unify")
    q_np = cs.zipf_queries(keys, 1 << 20, theta=cs.ZIPF_THETA, seed=seed)
    q = torch.from_numpy(to_biased(q_np)).to(device)
    want = torch.from_numpy(np.searchsorted(keys, q_np, "left")).to(device)
    cache = st._cache

    def run(overlap: bool) -> list:
        """One dispatch of ``q``, asynchronous: as served, or its launches
        made one by one with no overlap. Its ``LaneResult``s."""
        if overlap:
            return st.dispatch(q)
        starts = range(0, q.numel(), BLOCK)
        hits = (None if st._cache is None else
                torch.zeros(len(starts), dtype=torch.int32, device=device))
        res = []
        for k, j in enumerate(starts):
            h = None if hits is None else hits[k:k + 1]
            opt = {} if h is None else dict(cache=cache, hits=h)
            out = SL.stacked_lookup(st.planes, st.probe, q[j:j + BLOCK],
                                    **opt)[0]
            res.append(SL.LaneResult(out, h))
        return res

    turns = [(n, True) for n in libs] + [("served", False)]
    rows: dict = {}
    orig = SL.load_library
    try:
        for name, overlap in turns + turns[::-1]:
            SL.load_library = lambda _lib, lib=libs[name]: lib
            st._cache = cache
            cache.fill_(-1)
            run(overlap)
            warm = run(overlap)
            got = torch.cat([r.out for r in warm]).long()
            if not torch.equal(got, want):
                raise AssertionError(f"{dataset} {name}: ranks differ from "
                                     f"searchsorted")
            row = dict(warm=cs.device_ms(lambda: run(overlap), device,
                                         reps=10),
                       cold=cs.device_ms(lambda: (cache.fill_(-1),
                                                  run(overlap)),
                                         device, reps=10),
                       warm_hits=int(torch.cat([r.hits for r in warm]).sum()))
            st._cache = None
            row["off"] = cs.device_ms(lambda: run(overlap), device, reps=10)
            key = name if overlap else f"{name}_no_overlap"
            rows.setdefault(key, []).append(row)
    finally:
        SL.load_library = orig
        st._cache = cache
    return {k: {m: float(np.mean([r[m] for r in v])) for m in v[0]}
            for k, v in rows.items()}


def time_parent(parent: pathlib.Path, seed: int) -> list:
    """The uncached K1 of ``parent`` and of this checkout, in turns."""
    out = []
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                      ("parent", parent)):
        done = subprocess.run([sys.executable, "-c", TIMING, str(seed)],
                              cwd=root, capture_output=True, text=True,
                              timeout=600)
        lines = [ln for ln in done.stdout.splitlines()
                 if ln.startswith("TIMING ")]
        if done.returncode != 0 or not lines:
            raise RuntimeError(f"{tag} timing failed: "
                               f"{done.stderr[-4000:]}")
        out.append(dict(tree=tag, **json.loads(lines[-1][7:])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=16_000_000)
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cache_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.parent is not None:
        print(json.dumps({"parent_vs_this": time_parent(
            args.parent.resolve(), args.seed)}), flush=True)
    libs = build()
    for dataset in ("osm", "amzn"):
        print(json.dumps({"dataset": dataset, "keys": args.keys,
                          "slots": SLOTS, "ms": time_variants(
                              libs, dataset, args.keys, args.seed,
                              device)}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
