"""Train a small LM end to end with the port: the PLEX-packed data
pipeline, AdamW and checkpoint/restart (the port of
``examples/train_small.py``), on the CUDA card unless ``--device`` says
otherwise. Kill it mid-run and launch it again: it resumes from the newest
checkpoint in ``--ckpt-dir``.

    PYTHONPATH=src python -m repro_torch.launch.train_small [--steps 200] \\
        [--device cpu] [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs.base import ArchConfig
from ..convert import train_state_from_arrays, train_state_to_arrays
from ..data.packing import PackedPipeline, SyntheticCorpus
from ..device import resolve_device
from ..models import Model
from ..models.steps import init_train_state, make_train_step
from ..optim import cosine_schedule

# ~10M params: big enough to show real loss movement
CFG = ArchConfig(name="train-small-10m", family="dense", n_layers=4,
                 d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                 vocab=2048, remat="none", logits_chunk=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = Model(CFG)
    print(f"model: {CFG.n_params()/1e6:.1f}M params, device={device}")
    corpus = SyntheticCorpus(n_docs=20_000, vocab=CFG.vocab, seed=0)
    pipe = PackedPipeline(corpus, seq_len=args.seq, global_batch=args.batch)
    print(f"corpus: {corpus.total_tokens/1e6:.1f}M tokens, PLEX-packed "
          f"(spline={pipe.index.plex.spline.keys.size} pts, "
          f"layer={pipe.index.plex.tuning.kind})")

    lr = cosine_schedule(3e-3, warmup=20, total=args.steps)
    step_fn = make_train_step(model, lr=lr)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, every=50)

    params, opt = init_train_state(model, 0, device)

    def state():
        return train_state_to_arrays(CFG, params, opt)

    start = 0
    if mgr.steps():
        start, tree = mgr.restore_latest(state())
        params, opt = train_state_from_arrays(CFG, tree, device)
        start += 1
        print(f"resumed from step {start - 1}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch(step).items()}
        loss, params, opt = step_fn(params, opt, batch)
        losses.append(float(loss))
        mgr.maybe_save(step, state, blocking=False)
        if step % 10 == 0 or step == args.steps - 1:
            tps = (step - start + 1) * args.batch * args.seq / (time.time()
                                                                - t0)
            print(f"step {step:4d} loss {losses[-1]:.4f} ({tps:,.0f} tok/s)")
    mgr.save(args.steps - 1, state())
    mgr.wait()
    assert all(map(math.isfinite, losses)), "a loss is not finite"
    print(f"done; checkpoints in {args.ckpt_dir}: {mgr.steps()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
