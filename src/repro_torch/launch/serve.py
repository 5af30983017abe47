"""Serving launcher: batched continuous decoding with the PLEX-paged KV tier
(the port of ``repro.launch.serve``), on the CUDA card unless ``--device``
says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
      --smoke --device cpu --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --smoke --device cpu --production
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --smoke --device cpu --production

``--production`` applies the arch's ``PRODUCTION_OVERRIDES`` (deepseek-v2:
the weight-absorbed MLA decode; recurrentgemma: ``kv_replicate_to`` 16,
which leaves its ``wattn`` ring buffer at its one KV head) to the config,
smoke or full. The recurrent archs swap no pages out (their first block
holds no K/V).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, get_smoke
from ..configs.registry import with_production
from ..device import resolve_device
from ..models import Model
from ..serving import ServeEngine
from ..serving.engine import Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="apply the arch's production overrides")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.production:
        cfg = with_production(cfg, args.arch)
    model = Model(cfg)
    params = model.init(0, device=device)
    eng = ServeEngine(model, params, batch_size=args.batch,
                      max_seq=args.max_seq, device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(seq_id=i,
                           prompt=rng.integers(0, cfg.vocab, 8
                                               ).astype(np.int32),
                           max_new=args.max_new))
    t0 = time.time()
    fin = eng.run()
    dt = time.time() - t0
    toks = sum(len(f.tokens) for f in fin)
    pt = eng.kv_store.table
    print(f"[serve] {len(fin)} requests, {toks} tokens, {dt:.1f}s "
          f"({toks/dt:.1f} tok/s); page table: {len(pt)} pages, "
          f"{pt.rebuilds} PLEX rebuilds")


if __name__ == "__main__":
    main()
