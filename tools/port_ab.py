"""K5's time and minitron-4b's decode step on the card from two checkouts,
in turns (A, B, B, A).

    python3 tools/port_ab.py --a chip_tree/p --b .

Each turn is a subprocess that imports ``repro_torch`` from that tree's
``src/``, builds its K5 kernels from that tree's sources and times
``flash_attention_fwd`` with CUDA events (one warm-up call, then the mean
of ``--reps`` calls queued behind a spin kernel, as ``chip_smoke.py``'s
``device_ms``) at minitron-4b's prefill shape in bfloat16 (the Hopper
kernel) and at a 4,096-token shape in float32 (the SIMT kernel); then
minitron-4b at full width and depth (random weights from seed 0) decodes
``--steps`` steps of a batch of 4 through ``Model.serve_step`` on a
512-position cache, timed on the host clock with a synchronise (the median
step, after three warm-up steps). Prints one JSON line a turn, then a
summary line with each tree's mean and B over A. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

SHAPES = {"bf16_32k": ("bfloat16", 1, 32768, 24, 8, 128),
          "f32_4k": ("float32", 1, 4096, 24, 8, 128)}
METRICS = tuple(SHAPES) + ("decode_step_ms",)

TURN = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import flash_attention as FA
shapes = json.loads(sys.argv[2])
reps, steps = int(sys.argv[3]), int(sys.argv[4])
dev = torch.device("cuda", 0)
out = {"tree": sys.argv[1], "file": FA.__file__}
for name, (dt, b, s, h, kv, d) in shapes.items():
    g = torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, dt)
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, s, kv, d, generator=g, device=dev).to(dtype)
    fn = lambda: FA.flash_attention_fwd(q, k, v, causal=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    out[name] = start.elapsed_time(end) / reps
    del q, k, v
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.lm import init_cache
cfg = get_config("minitron-4b")
model = Model(cfg)
params = model.init(0, device=dev)
cache = init_cache(cfg, 4, 512, device=dev)
tok = torch.randint(0, cfg.vocab, (4, 1), device=dev)
times = []
for i in range(steps + 3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.serve_step(params, cache, tok, i)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
times = sorted(times[3:])
out["decode_step_ms"] = times[len(times) // 2]
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="the first tree (a checkout)")
    ap.add_argument("--b", required=True, help="the second tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    trees = {"a": str(pathlib.Path(args.a).resolve()),
             "b": str(pathlib.Path(args.b).resolve())}
    times: dict = {"a": [], "b": []}
    for who in ("a", "b", "b", "a"):
        r = subprocess.run([sys.executable, "-c", TURN, trees[who],
                            json.dumps(SHAPES), str(args.reps),
                            str(args.steps)],
                           capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": ""})
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": who, **rec}), flush=True)
        times[who].append(rec)
    summary = {}
    for name in METRICS:
        a = sum(t[name] for t in times["a"]) / 2
        b = sum(t[name] for t in times["b"]) / 2
        summary[name] = {"a_ms": a, "b_ms": b, "b_over_a": b / a}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
