#!/usr/bin/env python3
"""Where the summary probe's time goes, on one CUDA card.

    python3 tools/probe_split.py [--seed 0] [--queries 1048576]

Builds ``tools/probe_split.cu`` (variants of the summary probe of
``src/repro_torch/kernels/csrc/plex_device.cuh``) with ``nvcc`` and times,
with CUDA events, K4's work on 2^20 queries over a data plane of 2^24 keys
(one index) and of 200M keys (the service's 24 shards in one row): uniform
random keys drawn on the card from the seed, windows of 256 keys whose base
lies up to half a window below the answer. Each variant's answers are held
to ``torch.searchsorted``. Variants, each timed in turns (forward, then
backward):

* the probe with one and with two summary levels;
* its parts alone: the level-1 bisect without the data read, and the data
  segment read from the sample the bisect found;
* one 8-byte read at each answer (the byte bound's one sector a query, at
  the card's rate for scattered reads), and ``torch.take`` doing the same;
* the probe without its cache hints (plain loads for summary and data);
* two levels with the level-2 samples counted by independent loads instead
  of bisected.

Prints one JSON line per plane and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = {0: "one_level", 1: "two_levels", 2: "bisect_only",
            3: "segment_only", 4: "answer_read", 5: "one_level_no_hints",
            6: "two_levels_no_hints", 7: "two_levels_level2_counted"}
WINDOW = 256


class _Params(ctypes.Structure):
    """Mirror of ``SplitParams`` in ``probe_split.cu``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "dk", "s1", "s2", "q", "base", "given", "sample_out", "out")] + [
        (n, ctypes.c_int64) for n in ("n_q", "n_row", "n1")] + [
        ("window", ctypes.c_int32)]


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = _build.build_root() / "probe_split"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libprobe_split.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    "-I", str(_build.CSRC), "-o", str(lib),
                    str(ROOT / "tools" / "probe_split.cu")],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_split.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
    dll.probe_split.restype = ctypes.c_int
    return dll


def split(lib, n: int, n_q: int, seed: int, device) -> dict:
    import torch
    from chip_smoke import device_ms
    from repro_torch.kernels.planes import build_summary
    g = torch.Generator(device=device).manual_seed(seed)
    dk = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                       device=device).sort().values
    q = dk[torch.randint(0, n, (n_q,), generator=g, device=device)]
    lb = torch.searchsorted(dk, q)
    base = (lb - torch.randint(0, WINDOW // 2, lb.shape, generator=g,
                               device=device)).clamp(0, n - WINDOW).int()
    sm = build_summary(dk, n, 1)
    out = torch.empty(n_q, dtype=torch.int32, device=device)
    sample = torch.empty(n_q, dtype=torch.int64, device=device)
    p = _Params(dk=dk.data_ptr(), s1=sm.l1.data_ptr(), s2=sm.l2.data_ptr(),
                q=q.data_ptr(), base=base.data_ptr(),
                sample_out=sample.data_ptr(), out=out.data_ptr(), n_q=n_q,
                n_row=n, n1=sm.n1, window=WINDOW)

    def run(v: int):
        def call():
            p.given = (lb if v == 4 else sample).data_ptr()
            err = lib.probe_split(ctypes.addressof(p), v,
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {v}: CUDA error {err}")
        return call

    run(2)()                                # the samples variant 3 reads
    for v in VARIANTS:
        if v not in (2, 4):
            run(v)()
            torch.cuda.synchronize()
            if not torch.equal(out.long(), lb):
                raise AssertionError(f"{VARIANTS[v]} differs from "
                                     f"searchsorted on {n} keys")
    times: dict = {name: [] for name in VARIANTS.values()}
    order = list(VARIANTS)
    for v in order + order[::-1]:
        times[VARIANTS[v]].append(device_ms(run(v), device, reps=10))
    times["torch_take"] = [device_ms(lambda: torch.take(dk, lb), device,
                                     reps=10)]
    times["torch_searchsorted"] = [device_ms(
        lambda: torch.searchsorted(dk, q), device, reps=10)]
    return dict(keys=n, queries=n_q, window=WINDOW,
                summary_bytes=sm.nbytes, ms=times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    device = torch.device("cuda", 0)
    lib = build()
    for n in (1 << 24, 200_000_000):
        print(json.dumps(split(lib, n, args.queries, args.seed, device)),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
