"""Training launcher of the port (the port of ``repro.launch.train``), on
the CUDA card unless ``--device`` says otherwise.

Composes the substrate: the ``--arch`` config (full, ``--production`` or
``--smoke``), the PLEX-packed data pipeline, AdamW with the cosine
schedule, asynchronous PLEX-store checkpoints in the reference's layout
(so either package resumes the other's run) with resume on restart, the
straggler watchdog and optional error-feedback gradient compression.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \\
        --smoke --steps 100 --seq 64 --batch 8 --ckpt-dir /tmp/run1 \\
        [--device cpu]

``--grad-compress D`` sends each step's gradients through ``optim.
compress`` at density D before AdamW (the reference's launcher builds the
residual and leaves the gradients as they are: ROADMAP queue 3, R14); the
residual is not checkpointed, so a resumed run restarts it at zero. A
``frames`` config (hubert) needs frame batches, which the token pipeline
does not make; as in the reference, it does not train here.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke
from ..convert import train_state_from_arrays, train_state_to_arrays
from ..data.packing import PackedPipeline, SyntheticCorpus
from ..device import resolve_device
from ..models import Model
from ..models.steps import init_train_state, loss_and_grad, make_train_step
from ..optim import adamw_update, cosine_schedule
from ..optim.compress import compress_grads, compress_init
from .watchdog import StragglerWatchdog


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--production", action="store_true",
                    help="apply the registry's production overrides")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", type=float, default=0.0,
                    help="error-feedback top-k density (0 = off)")
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--host", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, *, stop_after: int | None = None
          ) -> dict:
    """The launcher's run: ``{"losses": {step: loss}, "params", "opt",
    "start", "report", "checkpoints"}``. ``stop_after`` leaves the loop
    after that step, without the final save, as a process killed there
    would (the save in flight is finished first, so the step it saves is
    on disk)."""
    cfg = (get_smoke(args.arch) if args.smoke
           else get_config(args.arch, production=args.production))
    device = resolve_device(args.device)
    model = Model(cfg)
    print(f"[train] arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"host={args.host}/{args.n_hosts} device={device}")

    corpus = SyntheticCorpus(n_docs=20_000, vocab=cfg.vocab, seed=0)
    pipe = PackedPipeline(corpus, seq_len=args.seq,
                          global_batch=args.batch, n_hosts=args.n_hosts)
    lr = cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                         total=args.steps)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, every=args.ckpt_every)
    dog = StragglerWatchdog(n_hosts=args.n_hosts)

    params, opt = init_train_state(model, 0, device)
    comp = compress_init(params) if args.grad_compress else None
    if comp is None:
        step_fn = make_train_step(model, lr=lr)
    else:
        def step_fn(params, opt, batch):
            nonlocal comp
            loss, grads = loss_and_grad(model, params, batch)
            grads, comp, _ = compress_grads(grads, comp,
                                            density=args.grad_compress)
            params, opt = adamw_update(grads, opt, params, lr=lr)
            return loss, params, opt

    def state():
        return train_state_to_arrays(cfg, params, opt)

    start = 0
    if mgr.steps():
        got = mgr.restore_latest(state())
        start, tree = got
        params, opt = train_state_from_arrays(cfg, tree, device)
        start += 1
        print(f"[train] resumed from step {start - 1}")

    losses: dict[int, float] = {}
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch(step, args.host).items()}
        loss, params, opt = step_fn(params, opt, batch)
        losses[step] = float(loss)
        dog.record(args.host, time.time() - t0)
        mgr.maybe_save(step, state, blocking=False)
        if step % 10 == 0 or step == args.steps - 1:
            rep = dog.report()
            print(f"[train] step {step} loss {losses[step]:.4f} "
                  f"median_step {rep['median_s']:.2f}s "
                  f"stragglers={rep['stragglers']}")
        if step == stop_after:
            mgr.wait()
            return dict(losses=losses, params=params, opt=opt, start=start,
                        report=dog.report(), checkpoints=mgr.steps())
    mgr.save(args.steps - 1, state())
    mgr.wait()
    print(f"[train] done; checkpoints: {mgr.steps()}")
    return dict(losses=losses, params=params, opt=opt, start=start,
                report=dog.report(), checkpoints=mgr.steps())


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
