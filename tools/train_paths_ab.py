#!/usr/bin/env python3
"""The recurrent prefills and the training step of two checkouts, in turns,
on one CUDA card.

    python3 tools/train_paths_ab.py --parent DIR [--seed 0] [--seq 32768]
                                    [--train-steps 6]

Runs the same measurement in ``--parent`` (another checkout, such as the
parent commit unpacked by ``git archive``) and in this one, each in a
process of its own with the checkout as its working directory, in turns
(parent, this, this, parent). Each process, through that checkout's own
``chip_smoke.py`` and ``repro_torch``:

* rwkv6-1.6b and recurrentgemma-9b at full width and depth, random bf16
  weights from ``--seed``: a prefill of ``--seq`` tokens at batch 1
  (``make_prefill_step``) after a warm-up, timed on the host clock around
  a synchronised call, three times for rwkv6 and twice for
  recurrentgemma (their median), and the peak memory of those calls;
* qwen2-vl-2b's ``make_train_step`` at full width and depth, 4,096 tokens
  at batch 8, ``--train-steps`` steps over the packed pipeline's batches
  (``chip_smoke.train_main_path``): the median step of steps 2 and on,
  tokens/s, the peak memory, and the attention backward's device ms in the
  last step (CUDA events).

Prints one JSON line per process and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# one checkout's numbers (run with that checkout as the working directory);
# both trees have these entry points
TIMING = r'''
import gc, json, statistics, sys
import torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.models.steps import make_prefill_step
seed, seq, steps = (int(a) for a in sys.argv[1:4])
d = torch.device("cuda", 0)
torch.cuda.set_device(d)
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for arch, reps in (("rwkv6-1.6b", 3), ("recurrentgemma-9b", 2)):
    cfg = get_config(arch)
    model, params, _, _ = cs.drawn_model(d, seed, cfg)
    prefill = make_prefill_step(model)
    gen = torch.Generator(device=d).manual_seed(seed + 9)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=d)
    cs.timed(lambda: prefill(params, {"tokens": tokens[:, :256]}), d)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(d)
    secs = [cs.timed(lambda: prefill(params, {"tokens": tokens}), d)[1]
            for _ in range(reps)]
    out[arch] = dict(ttft_s=secs, ttft_s_median=statistics.median(secs),
                     max_memory_allocated=torch.cuda.max_memory_allocated(d))
    del model, params, prefill, tokens
    gc.collect()
    torch.cuda.empty_cache()
tr = cs.train_main_path(d, seed, get_config("qwen2-vl-2b"), 4096, 8, steps)
out["qwen2-vl-2b_train"] = {k: tr[k] for k in (
    "step_s_median", "tokens_per_s", "max_memory_allocated",
    "attention_backward_ms", "evented_step_ms", "attention_backward_share",
    "k5_launches_per_step")}
out["qwen2-vl-2b_train"]["step_s"] = [r["seconds"] for r in tr["steps"]]
print("TIMING " + json.dumps(out), flush=True)
'''


def time_trees(parent: pathlib.Path, seed: int, seq: int,
               steps: int) -> list:
    """Each checkout's numbers, in turns."""
    rows = []
    for tag, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                      ("parent", parent)):
        done = subprocess.run(
            [sys.executable, "-c", TIMING, str(seed), str(seq), str(steps)],
            cwd=root, capture_output=True, text=True, check=False)
        line = [x for x in done.stdout.splitlines()
                if x.startswith("TIMING ")]
        if done.returncode != 0 or not line:
            raise RuntimeError(f"{tag} ({root}) failed:\n"
                               f"{done.stdout[-3000:]}\n{done.stderr[-4000:]}")
        rows.append({"tree": tag, **json.loads(line[-1][len("TIMING "):])})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--train-steps", type=int, default=6)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card, flush=True)
    time_trees(args.parent.resolve(), args.seed, args.seq, args.train_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
