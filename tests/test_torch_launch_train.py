"""The port's training loop end to end on the CPU: the port's versions of
``tests/test_system.py``'s training tests (the loss falls; kill, restore
and replay equal the uninterrupted run; error-feedback compression tracks
full gradients) and of ``tests/test_substrate.py``'s watchdog test, the
launcher (``repro_torch.launch.train``) resuming its own run and the
reference's checkpoints, and the two training examples
(``train_small``, ``packing_pipeline``) at small sizes.
"""
import jax
import numpy as np
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.configs import get_smoke as r_get_smoke
from repro.models import Model as RModel
from repro.models.steps import init_train_state as r_init_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.convert import train_state_from_arrays, \
    train_state_to_arrays
from repro_torch.data.packing import PackedPipeline, SyntheticCorpus
from repro_torch.launch import packing_pipeline, train, train_small
from repro_torch.launch.watchdog import StragglerWatchdog
from repro_torch.models import Model
from repro_torch.models.steps import (init_train_state, loss_and_grad,
                                      make_train_step)
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import leaves
from repro_torch.optim.compress import compress_grads, compress_init

CPU = "cpu"


def _pipeline(cfg):
    corpus = SyntheticCorpus(n_docs=800, vocab=cfg.vocab, seed=11,
                             mean_len=96)
    return PackedPipeline(corpus, seq_len=32, global_batch=4)


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_train_loss_decreases():
    cfg = get_smoke("phi3-mini-3.8b")
    m = Model(cfg)
    pipe = _pipeline(cfg)
    params, opt = init_train_state(m, 0, CPU)
    step_fn = make_train_step(m, lr=3e-3)
    losses = []
    for step in range(30):
        loss, params, opt = step_fn(params, opt, _batch(pipe.batch(step)))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_checkpoint_restart_bitexact_trajectory(tmp_path):
    """Kill + restore_latest + replay equals no kill (the port, on the
    CPU: bit for bit)."""
    cfg = get_smoke("qwen2-vl-2b")
    m = Model(cfg)
    pipe = _pipeline(cfg)
    step_fn = make_train_step(m, lr=1e-3)

    def run(n0, n1, params, opt):
        losses = []
        for step in range(n0, n1):
            loss, params, opt = step_fn(params, opt, _batch(pipe.batch(step)))
            losses.append(float(loss))
        return losses, params, opt

    base_losses, base_params, _ = run(0, 10, *init_train_state(m, 0, CPU))
    mgr = CheckpointManager(tmp_path, keep=2, every=5)
    params, opt = init_train_state(m, 0, CPU)
    for step in range(6):        # crashes after step 5 (saved at step 5)
        _, params, opt = step_fn(params, opt, _batch(pipe.batch(step)))
        mgr.maybe_save(step, lambda: train_state_to_arrays(cfg, params, opt),
                       blocking=True)
    # --- simulated failure; fresh process state ---
    params2, opt2 = init_train_state(m, 0, CPU)
    step0, state = mgr.restore_latest(train_state_to_arrays(cfg, params2,
                                                            opt2))
    assert step0 == 5
    params2, opt2 = train_state_from_arrays(cfg, state, CPU)
    resumed, res_params, _ = run(step0 + 1, 10, params2, opt2)
    assert resumed == base_losses[6:]
    for a, b in zip(leaves(base_params), leaves(res_params)):
        assert torch.equal(a, b)


def test_grad_compression_convergence():
    cfg = get_smoke("phi3-mini-3.8b")
    m = Model(cfg)
    pipe = _pipeline(cfg)

    def run(density):
        params, opt = init_train_state(m, 0, CPU)
        comp = compress_init(params)
        losses = []
        for s in range(25):
            loss, grads = loss_and_grad(m, params, _batch(pipe.batch(s)))
            if density:
                grads, comp, _ = compress_grads(grads, comp, density=density)
            params, opt = adamw_update(grads, opt, params, lr=3e-3)
            losses.append(float(loss))
        return losses

    full = run(0.0)
    sparse = run(0.10)
    assert np.isfinite(sparse).all()
    assert np.mean(sparse[-5:]) < np.mean(sparse[:5])
    assert np.mean(sparse[-5:]) < np.mean(full[-5:]) * 1.10


def test_straggler_watchdog():
    dog = StragglerWatchdog(n_hosts=8, threshold=1.5)
    for step in range(10):
        for h in range(8):
            dog.record(h, 1.0 if h != 3 else 2.5)   # host 3 is slow
    assert dog.stragglers() == [3]
    rep = dog.report()
    assert abs(rep["median_s"] - 1.0) < 0.05
    for _ in range(30):
        dog.record(3, 1.0)
    assert dog.stragglers() == []


def _args(tmp, *extra):
    return train.parse_args(["--arch", "qwen2-vl-2b", "--smoke", "--steps",
                             "10", "--seq", "32", "--batch", "4",
                             "--ckpt-every", "5", "--ckpt-dir", str(tmp),
                             "--device", CPU, *extra])


def test_launcher_resume_equals_uninterrupted(tmp_path):
    """The launcher stopped after step 5 and launched again resumes from
    its step-5 checkpoint; its losses and final state equal an
    uninterrupted run's, bit for bit on the CPU. The files are the
    reference's format: its manager restores the port's newest one."""
    whole = train.train(_args(tmp_path / "whole"))
    first = train.train(_args(tmp_path / "cut"), stop_after=5)
    assert first["checkpoints"] == [0, 5]
    rest = train.train(_args(tmp_path / "cut"))
    assert rest["start"] == 6
    assert {**first["losses"], **rest["losses"]} == whole["losses"]
    for a, b in zip(leaves(whole["params"]), leaves(rest["params"])):
        assert torch.equal(a, b)
    rparams, ropt, _ = r_init_train_state(RModel(r_get_smoke("qwen2-vl-2b")),
                                          jax.random.PRNGKey(0))
    step, state = RManager(tmp_path / "cut").restore_latest(
        {"params": rparams, "opt": ropt})
    assert step == 9
    want = train_state_to_arrays(get_smoke("qwen2-vl-2b"), rest["params"],
                                 rest["opt"])
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launcher_resumes_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference's manager wrote (its initial state, as
    step 3) is where the port's launcher resumes: step 4 on, from exactly
    that state."""
    cfg = r_get_smoke("qwen2-vl-2b")
    rparams, ropt, _ = r_init_train_state(RModel(cfg), jax.random.PRNGKey(7))
    state = {"params": jax.tree.map(np.asarray, rparams),
             "opt": jax.tree.map(np.asarray, ropt)}
    RManager(tmp_path, keep=3, every=1).save(3, state)
    seen = {}
    real = train.train_state_from_arrays

    def spy(cfg_, tree, device):
        seen["tree"] = tree
        return real(cfg_, tree, device)
    train.train_state_from_arrays = spy
    try:
        out = train.train(_args(tmp_path, "--steps", "5"))
    finally:
        train.train_state_from_arrays = real
    assert out["start"] == 4 and sorted(out["losses"]) == [4]
    for a, b in zip(jax.tree.leaves(seen["tree"]), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launcher_grad_compress_runs(tmp_path):
    out = train.train(_args(tmp_path, "--steps", "3", "--grad-compress",
                            "0.1"))
    assert np.isfinite(list(out["losses"].values())).all()
    assert sorted(out["losses"]) == [0, 1, 2]


def test_train_small_example(tmp_path):
    assert train_small.main(["--steps", "12", "--batch", "2", "--seq", "32",
                             "--ckpt-dir", str(tmp_path), "--device",
                             CPU]) == 0
    assert CheckpointManager(tmp_path).steps() == [0, 11]


def test_packing_pipeline_example():
    assert packing_pipeline.main(["--docs", "50000", "--queries",
                                  "100000"]) == 0
