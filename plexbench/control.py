"""The control of ``correct``: the plain reference put in the service's
place and computed at the nearest narrower key width, each key and query cut
to its high 32-bit word (a 32-bit key plane halves the bytes a lookup reads,
the step that would tempt a later change). Its answers break the
configurations' guarantee (the exact first-occurrence rank) wherever two
keys share a high word, so every run it serves must come out not correct.

On the card, at a cell's own size, over several seeds:

    python3 plexbench/control.py --workload osm-uniform \
        --seeds 11,12,13 --seconds 10

prints one JSON line a seed: ``correct`` and the numbers compared. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

HI = np.uint64(32)


class _Answered:
    """A ticket whose answers are already in."""

    def __init__(self, out: np.ndarray):
        self.out = out

    def result(self, timeout: float | None = None) -> np.ndarray:
        return self.out


class Narrowed:
    """``submit(q)`` answered by ``ranks`` over the keys' high words."""

    def __init__(self, keys: np.ndarray, ranks):
        self.hi = (keys >> HI).astype(np.uint32)
        self.ranks = ranks

    def submit(self, q: np.ndarray) -> _Answered:
        return _Answered(self.ranks(self.hi, (q >> HI).astype(np.uint32)))


def factory(bench):
    """A ``service_factory`` for ``harness.run_cell``: the configuration's
    own reference over narrowed keys."""
    def make(keys: np.ndarray, config: dict, device) -> Narrowed:
        return Narrowed(keys, bench.module("references",
                                           config["reference"]).ranks)
    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from plexbench import harness
    bench = harness.Bench(root)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(root, args.workload, seed, args.seconds, False,
                               device=args.device,
                               service_factory=factory(bench))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
