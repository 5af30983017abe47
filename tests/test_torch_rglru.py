"""The port's RG-LRU block against the reference (``repro.layers.rglru``).

The reference draws one layer's weights for the recurrentgemma smoke config
(``d_model`` and ``rnn_width`` 64, a conv of width 4); the port gets the
same arrays, and the same numpy inputs go through both: the causal conv
with and without a decode tail (its taps summed in the reference's order,
so in bfloat16 too), the recurrence with and without an incoming ``h0``
(the reference's ``jax.lax.associative_scan``; the port's doubling scan,
another float32 summation order), and the whole block in prefill and in a
decode step from a random float32 state. Tolerances, as in
``test_torch_moe.py``: float32 rtol 1e-4 and atol 1e-4 of the tensor's
largest magnitude; bfloat16 every element within 5e-2 of that magnitude.
The block's output is not normalised (unit-scale weights of one stacked
layer), so an element near zero carries the rounding of large terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.layers import rglru as r_rglru
from repro.parallel import ParamCollector
from repro_torch.configs import get_smoke
from repro_torch.layers import rglru

ARCH = "recurrentgemma-9b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 40


def _close(got, want, tol):
    got = np.asarray(got.float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if tol == TOL["bfloat16"]:
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, err
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _params(seed=0):
    p = r_rglru.init_rglru(ParamCollector(), 1, r_get_smoke(ARCH),
                           jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.array(a[0]), p)


def _state(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(0, 1, (B, cfg.conv_width - 1, cfg.rnn_width)
                               ).astype(np.float32),
            "h": rng.normal(0, 1, (B, cfg.rnn_width)).astype(np.float32)}


def test_constant_matches():
    assert rglru.RGLRU_C == r_rglru.RGLRU_C


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype, tail):
    """y in the activation dtype, the new tail float32."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (B, 9, 16)).astype(np.float32)
    w = rng.normal(0, 1, (4, 16)).astype(np.float32)
    b = rng.normal(0, 1, 16).astype(np.float32)
    t = rng.normal(0, 1, (B, 3, 16)).astype(np.float32) if tail else None
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, nt = rglru._causal_conv(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(b).to(tdt), None if t is None else
        torch.from_numpy(t))
    ry, rnt = r_rglru._causal_conv(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        None if t is None else jnp.asarray(t))
    assert y.dtype == tdt and nt.dtype == torch.float32
    _close(y, ry, TOL[dtype])
    _close(nt, rnt, TOL[dtype])


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_scan_matches_reference(h0):
    """Over 1,000 positions (ten doubling steps), h0 folded into step 0."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, 1000, 8)).astype(np.float32)
    a = rng.uniform(0.5, 1, (B, 1000, 8)).astype(np.float32)
    h = rng.normal(0, 1, (B, 8)).astype(np.float32) if h0 else None
    got = rglru._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                            None if h is None else torch.from_numpy(h))
    want = r_rglru._rglru_scan(jnp.asarray(x), jnp.asarray(a),
                               None if h is None else jnp.asarray(h))
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rglru_matches_reference(dtype, decode):
    """Prefill over 40 positions, or one decode step from a random float32
    state: y and the new state."""
    cfg, tcfg = r_get_smoke(ARCH), get_smoke(ARCH)
    p = _params()
    x = np.random.default_rng(4).normal(0, 1, (B, 1 if decode else S,
                                               cfg.d_model)
                                        ).astype(np.float32)
    state = _state(cfg) if decode else None
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, st = rglru.apply_rglru(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(tdt), tcfg,
        state=None if state is None else
        {k: torch.from_numpy(v) for k, v in state.items()})
    ry, rst = r_rglru.apply_rglru(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt), cfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    assert y.dtype == tdt
    _close(y, ry, TOL[dtype])
    if not decode:
        assert st is None and rst is None
        return
    assert st["conv"].dtype == st["h"].dtype == torch.float32
    _close(st["conv"], rst["conv"], TOL[dtype])
    _close(st["h"], rst["h"], TOL[dtype])
