"""The port's RWKV6 layers against the reference (``repro.layers.rwkv``).

The reference draws one layer's time-mix and channel-mix weights for the
rwkv6 smoke config (``d_model`` 64, heads of 16); the port gets the same
arrays, and the same numpy inputs go through both: ``group_norm_heads``,
the chunked WKV (``_wkv_chunked``: several chunks, one chunk, one short
chunk of 7), the one-step decode recurrence (``wkv_step``), and both mixes
with and without decode state. The port runs the chunk-to-chunk state
recurrence as a log-depth scan where the reference scans the chunks one by
one: the same function in another float32 summation order. Tolerances, as
in ``test_torch_moe.py``: float32 rtol 1e-4 and atol 1e-4 of the tensor's
largest magnitude; bfloat16 every element within 5e-2 of that magnitude.
The layers' outputs are not normalised: with the reference's init (one
stacked layer, unit-scale weights) they reach the tens, and an element near
zero is a sum of such terms that carries their float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.layers import norms as r_norms
from repro.layers import rwkv as r_rwkv
from repro.parallel import ParamCollector
from repro_torch.configs import get_smoke
from repro_torch.layers import norms, rwkv
from repro_torch.layers.scan import linear_scan

ARCH = "rwkv6-1.6b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 32


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


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _layer(init, seed=0):
    """One layer's weights drawn by the reference (numpy, stacked dim
    dropped)."""
    p = init(ParamCollector(), 1, r_get_smoke(ARCH), jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.array(a[0]), p)


def _wkv_inputs(s, seed=0, h=3, d=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, s, h, d)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.abs(rng.normal(0.5, 0.5, (B, s, h, d))),
                      rwkv.LOGW_MIN).astype(np.float32)
    u = rng.normal(0, 1, (h, d)).astype(np.float32)
    return r, k, v, logw, u


def _state(d, h, hs, seed=3):
    rng = np.random.default_rng(seed)
    return {"shift": rng.normal(0, 1, (B, d)).astype(np.float32),
            "wkv": rng.normal(0, 1, (B, h, hs, hs)).astype(np.float32)}


def test_constants_match():
    assert (rwkv.LOGW_MIN, rwkv.CHUNK) == (r_rwkv.LOGW_MIN, r_rwkv.CHUNK)
    p = _layer(r_rwkv.init_rwkv_time)
    assert p["wa"].shape[-1] == rwkv.LORA


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_heads_matches(dtype):
    """Population variance (``jnp.var``), eps 64e-5, float32 statistics."""
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 3, (B, 5, 4, 16)).astype(np.float32)
    w = rng.normal(1, 0.1, (4, 16)).astype(np.float32)
    b = rng.normal(0, 0.1, (4, 16)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = norms.group_norm_heads(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(w), torch.from_numpy(b))
    want = r_norms.group_norm_heads(jnp.asarray(x, jdt), jnp.asarray(w),
                                    jnp.asarray(b))
    assert got.dtype == tdt
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("s", [16, 48, 7])
def test_wkv_chunked_matches_reference(s):
    """One chunk, three chunks, and one short chunk of 7 positions: the
    outputs and the final state."""
    r, k, v, logw, u = _wkv_inputs(s)
    o, st = rwkv._wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, u)))
    ro, rst = r_rwkv._wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u)))
    _close(o, ro, TOL["float32"])
    _close(st, rst, TOL["float32"])


def test_wkv_chunked_keeps_the_reference_assertion():
    """S not a multiple of min(16, S) is refused, not padded."""
    r, k, v, logw, u = _wkv_inputs(20)
    with pytest.raises(AssertionError):
        rwkv._wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, u)))


def test_wkv_step_matches_reference():
    r, k, v, logw, u = _wkv_inputs(1, seed=2)
    state = np.random.default_rng(4).normal(0, 1, (B, 3, 8, 8)
                                            ).astype(np.float32)
    args = (state, r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u)
    st, o = rwkv.wkv_step(*map(torch.from_numpy, args))
    rst, ro = r_rwkv.wkv_step(*map(jnp.asarray, args))
    _close(o, ro, TOL["float32"])
    _close(st, rst, TOL["float32"])


def test_linear_scan_equals_the_loop():
    """The doubling scan against the recurrence written as a loop, with a
    broadcast per-row decay of a matrix state, at a length that is not a
    power of two."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0, 1, (2, 37, 3, 4, 1)
                                     ).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, 37, 3, 4, 4)
                                    ).astype(np.float32))
    h, want = torch.zeros_like(b[:, 0]), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = linear_scan(a, b, dim=1)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert a.shape == (2, 37, 3, 4, 1)        # the inputs are left as given


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_reference(dtype, decode):
    """Prefill (no state) over 32 positions, or one decode step from a
    random float32 state: y and the new state."""
    cfg, tcfg = r_get_smoke(ARCH), get_smoke(ARCH)
    p = _layer(r_rwkv.init_rwkv_time)
    s = 1 if decode else S
    x = np.random.default_rng(6).normal(0, 1, (B, s, cfg.d_model)
                                        ).astype(np.float32)
    hs = cfg.rwkv_head_size
    state = _state(cfg.d_model, cfg.d_model // hs, hs) if decode else None
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, st = rwkv.apply_rwkv_time(
        _torch_tree(p), torch.from_numpy(x).to(tdt), tcfg,
        state=None if state is None else _torch_tree(state))
    ry, rst = r_rwkv.apply_rwkv_time(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt), cfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    assert y.dtype == tdt
    _close(y, ry, TOL[dtype])
    if not decode:
        assert st is None and rst is None
        return
    assert st["shift"].dtype == st["wkv"].dtype == torch.float32
    _close(st["shift"], rst["shift"], TOL[dtype])
    _close(st["wkv"], rst["wkv"], TOL[dtype])


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype, decode):
    cfg = r_get_smoke(ARCH)
    p = _layer(r_rwkv.init_rwkv_channel, seed=1)
    s = 1 if decode else S
    x = np.random.default_rng(7).normal(0, 1, (B, s, cfg.d_model)
                                        ).astype(np.float32)
    state = ({"shift": _state(cfg.d_model, 1, 1)["shift"]} if decode
             else None)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, st = rwkv.apply_rwkv_channel(
        _torch_tree(p), torch.from_numpy(x).to(tdt),
        state=None if state is None else _torch_tree(state))
    ry, rst = r_rwkv.apply_rwkv_channel(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt),
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    assert y.dtype == tdt
    _close(y, ry, TOL[dtype])
    if decode:
        assert st["shift"].dtype == torch.float32
        _close(st["shift"], rst["shift"], TOL[dtype])
    else:
        assert st is None and rst is None
