"""End-to-end serving driver of the port: batched requests through a small
model with PLEX-paged KV swap-out, the paper's technique serving the page
table (the port of ``examples/serve_paged.py``), on the CUDA card unless
``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve_paged [--device cpu] \\
        [--arch phi3-mini-3.8b] [--requests 8] [--max-new 16]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_smoke
from ..device import resolve_device
from ..models import Model
from ..serving import ServeEngine
from ..serving.engine import Request

SWAP_IN_TOKENS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    model = Model(cfg)
    params = model.init(0, device=device)
    eng = ServeEngine(model, params, batch_size=4, max_seq=128,
                      device=device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12))
        eng.submit(Request(seq_id=i, prompt=prompt.astype(np.int32),
                           max_new=args.max_new))

    t0 = time.perf_counter()
    finished = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(f.tokens) for f in finished)
    print(f"arch={cfg.name}: served {len(finished)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s, smoke scale on {device})")
    assert len(finished) == args.requests
    for f in finished[:4]:
        print(f"  seq {f.seq_id}: {f.tokens[:8].tolist()}... "
              f"({f.swapped_pages} KV pages swapped via PLEX page table)")
    pt = eng.kv_store.table
    print(f"page table: {len(pt)} mappings, {pt.lookups} lookups, "
          f"{pt.rebuilds} PLEX rebuilds")
    # pull one sequence back from the paged store (resume path)
    kv = eng.kv_store.fetch(finished[0].seq_id, SWAP_IN_TOKENS)
    assert kv.shape[0] == SWAP_IN_TOKENS
    print(f"swap-in OK: restored KV block shape {kv.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
