"""AdamW, the cosine schedule and the error-feedback compression of the
port against the reference (``repro.optim``), on the same numpy arrays.

AdamW: five steps with the global-norm clip active (gradients of norm
about 10^3 against ``clip_norm`` 1) and weight decay, a schedule as the
learning rate; parameters and both moments within 1e-6 (rtol and atol),
the step count exact. The schedule: its float32 value at every step from 0
to 250 within 1e-6 relative (the two libraries' float32 cosines differ in
the last place at a few steps). The compression: ties at the k-th largest magnitude keep
every tied element (more than k), exactly the reference's sent values and
residuals. Also the port's versions of ``tests/test_optim.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import cosine_schedule as r_cosine_schedule
from repro.optim.compress import compress_grads as r_compress_grads
from repro.optim.compress import compress_init as r_compress_init
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.optim.compress import compress_grads, compress_init


def _tree(rng, scale=1.0):
    return {"a": (rng.normal(0, scale, (6, 5))).astype(np.float32),
            "b": {"c": (rng.normal(0, scale, (7,))).astype(np.float32),
                  "d": (rng.normal(0, scale, (3, 2, 2))).astype(np.float32)}}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_adamw_with_clipping_matches():
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    rp, rs = jax.tree.map(jnp.asarray, p0), None
    rs = r_adamw_init(rp)
    tp = _t({k: (v.copy() if isinstance(v, np.ndarray) else
                 jax.tree.map(np.copy, v)) for k, v in p0.items()})
    ts = adamw_init(tp)
    r_lr = r_cosine_schedule(1e-2, warmup=2, total=5)
    t_lr = cosine_schedule(1e-2, warmup=2, total=5)
    for _ in range(5):
        g = _tree(rng, scale=300.0)
        gnorm = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2))
                            for x in jax.tree.leaves(g)))
        assert gnorm > 100                         # the clip is active
        rp, rs = r_adamw_update(jax.tree.map(jnp.asarray, g), rs, rp,
                                lr=r_lr)
        tp2, ts = adamw_update(_t(g), ts, tp, lr=t_lr)
        assert tp2 is tp                           # updated in place
    assert int(ts.step) == int(rs.step) == 5
    for got, want in ((tp, rp), (ts.m, rs.m), (ts.v, rs.v)):
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_schedule_matches():
    r_lr = r_cosine_schedule(3e-3, warmup=20, total=200)
    t_lr = cosine_schedule(3e-3, warmup=20, total=200)
    steps = np.arange(0, 251, dtype=np.int32)
    want = np.asarray([float(r_lr(jnp.asarray(s))) for s in steps],
                      np.float32)
    got = t_lr(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_compression_with_ties_matches_exactly():
    """Magnitudes with ties at the k-th largest (density 0.1 of 40: k = 4,
    six elements share the 4th magnitude), twice, the residual feeding
    back."""
    g = np.zeros(40, np.float32)
    g[:3] = [9.0, -8.0, 7.0]
    g[3:9] = [5.0, -5.0, 5.0, -5.0, 5.0, 5.0]
    g[9:] = np.linspace(-1, 1, 31).astype(np.float32)
    grads = {"w": g.reshape(5, 8), "b": g[:10] * 0.5}
    rs = r_compress_init(jax.tree.map(jnp.asarray, grads))
    ts = compress_init(_t(grads))
    for _ in range(2):
        rsent, rs, rstats = r_compress_grads(
            jax.tree.map(jnp.asarray, grads), rs, density=0.1)
        tsent, ts, tstats = compress_grads(_t(grads), ts, density=0.1)
        assert tstats == rstats
        for k in grads:
            np.testing.assert_array_equal(tsent[k].numpy(),
                                          np.asarray(rsent[k]))
            np.testing.assert_array_equal(ts.residual[k].numpy(),
                                          np.asarray(rs.residual[k]))
    assert int((tsent["w"] != 0).sum()) > 4       # ties kept beyond k


def test_compression_error_feedback_identity():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.normal(0, 1, (32, 32)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(0, 1, (128,)).astype(np.float32))}
    sent, st, stats = compress_grads(g, compress_init(g), density=0.05)
    for k in g:
        torch.testing.assert_close(sent[k] + st.residual[k], g[k],
                                   rtol=0, atol=1e-6)
    dens = sum(int((sent[k] != 0).sum()) for k in g) / stats["total_elems"]
    assert dens <= 0.12


def test_adamw_minimises_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    target = torch.tensor([1.0, 2.0, -1.0])
    opt = adamw_init(params)
    loss0 = float(((params["w"] - target) ** 2).sum())
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, opt = adamw_update(g, opt, params, lr=0.05,
                                   weight_decay=0.0)
    assert float(((params["w"] - target) ** 2).sum()) < 1e-2 * loss0
    assert int(opt.step) == 300 and isinstance(opt, AdamWState)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    p2, _ = adamw_update({"w": torch.full((4,), 1e9)}, opt, params, lr=1.0,
                         weight_decay=0.0, clip_norm=1.0)
    assert bool((p2["w"].abs() < 10.0).all())


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    xs = [float(lr(torch.tensor(s))) for s in (0, 5, 10, 50, 100, 200)]
    assert xs[0] == 0.0 and abs(xs[2] - 1e-3) < 1e-9
    assert xs[3] < xs[2] and xs[4] <= xs[3]
    assert xs[5] >= 1e-4 * 0.99
