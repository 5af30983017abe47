"""Data-pipeline example of the port: PLEX-indexed sequence packing at
corpus scale (the port of ``examples/packing_pipeline.py``). The
position-to-document predecessor query, vectorised over a full global
batch, against a multi-million-document boundary array, on the host (as
the reference's); every answer must equal ``np.searchsorted``.

    PYTHONPATH=src python -m repro_torch.launch.packing_pipeline \\
        [--docs 2000000] [--queries 1000000]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..data.packing import PackedIndex, SyntheticCorpus


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=2_000_000)
    ap.add_argument("--queries", type=int, default=1_000_000)
    args = ap.parse_args(argv)

    corpus = SyntheticCorpus(n_docs=args.docs, vocab=32_000, seed=0)
    print(f"corpus: {args.docs/1e6:.1f}M docs, "
          f"{corpus.total_tokens/1e9:.2f}B tokens")

    t0 = time.perf_counter()
    index = PackedIndex(corpus, eps=64)
    t_build = time.perf_counter() - t0
    px = index.plex
    print(f"PLEX over boundaries: built in {t_build:.2f}s "
          f"(spline {px.spline.keys.size} pts, layer {px.tuning.kind} "
          f"r={px.tuning.r}, size {px.size_bytes/1024:.0f} KiB)")

    rng = np.random.default_rng(0)
    pos = rng.integers(0, corpus.total_tokens - 1, args.queries
                       ).astype(np.uint64)

    t0 = time.perf_counter()
    docs, offs = index.locate(pos)
    t_plex = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref = np.searchsorted(corpus.boundaries, pos, side="right") - 1
    t_np = time.perf_counter() - t0

    assert np.array_equal(docs, ref)
    print(f"{args.queries/1e6:.1f}M locates: PLEX {t_plex:.3f}s "
          f"({t_plex/args.queries*1e9:.0f} ns/q) vs np.searchsorted "
          f"{t_np:.3f}s ({t_np/args.queries*1e9:.0f} ns/q), exact")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
