"""The port's capacity-dropping MoE against the reference.

For both MoE smoke configs (deepseek-v2, qwen2-moe) the reference draws
one layer's router, experts and shared MLP; the port gets the same arrays,
and the same numpy input goes through ``repro_torch.layers.moe.apply_moe``
and ``repro.layers.moe._apply_moe_gspmd`` (and the reference's own
``apply_moe`` with the production ``moe_impl="shard_map"``, which computes
the same function without a mesh). The routing is checked first, exactly:
each token's experts (``idx``) and which (token, slot) pairs are kept
(``keep``) against a transcription of the reference's routing lines, so a
flipped expert shows as a named mismatch. Then ``y`` and the aux loss:
in float32 rtol 1e-4 and atol 1e-4 of the tensor's largest magnitude; in
bfloat16 every element within 5e-2 of that magnitude. The layer's output
is not normalised: with the reference's init (one stacked layer, unit
weights) it reaches the hundreds, and an element near zero is a sum of
such terms that carries their float32 rounding. One case makes the
capacity bind (a router biased toward two experts over 512 tokens) and
must drop the same pairs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.layers import moe as r_moe
from repro.parallel import ParamCollector
from repro_torch.configs import get_smoke
from repro_torch.layers import moe
from repro_torch.models.init import ParamInit

MOE = ["deepseek-v2-236b", "qwen2-moe-a2.7b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


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


def _layer(arch: str, seed: int = 0, bias: float = 0.0):
    """The reference's config and one MoE layer's params (numpy), the
    port's config; ``bias`` > 0 tilts the router toward experts 0 and 1
    along the direction ``_inputs`` adds to every token."""
    cfg = r_get_smoke(arch)
    p = r_moe.init_moe(ParamCollector(), 1, cfg, jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda a: np.array(a[0]), p)
    if bias:
        u = _direction(cfg.d_model)
        p["router"][:, :2] += bias * u[:, None]
    return cfg, p, get_smoke(arch)


def _direction(d: int) -> np.ndarray:
    u = np.random.default_rng(99).normal(0, 1, d).astype(np.float32)
    return u / np.linalg.norm(u)


def _inputs(cfg, shape, seed=0, tilt=0.0):
    x = np.random.default_rng(seed).normal(0, 1, (*shape, cfg.d_model))
    return (x + tilt * _direction(cfg.d_model)).astype(np.float32)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _ref_routing(p, x, cfg):
    """``_apply_moe_gspmd``'s routing lines (``repro/layers/moe.py``:
    logits to ``keep``), in jnp: -> idx [T,k], keep [T,k], cap."""
    t = x.shape[0] * x.shape[1]
    e = p["router"].shape[-1]
    k = cfg.top_k
    cap = int(np.ceil(t * k / e * cfg.capacity_factor))
    cap = max(((cap + 127) // 128) * 128, 128)
    xt = x.reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        jnp.asarray(p["router"], jnp.float32))
    if e > cfg.n_experts:
        logits = jnp.where((jnp.arange(e) >= cfg.n_experts)[None, :], -1e30,
                           logits)
    _, idx = jax.lax.top_k(logits, k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, -1).reshape(t, k)
    return np.asarray(idx), np.asarray(pos < cap), cap


def _run(arch, dtype, shape, *, bias=0.0, tilt=0.0, impl="gspmd"):
    """(port routing, port (y, aux), reference idx/keep/cap, reference
    (y, aux)) on one input."""
    cfg, p, tcfg = _layer(arch, bias=bias)
    cfg = dataclasses.replace(cfg, moe_impl=impl)
    tcfg = dataclasses.replace(tcfg, moe_impl=impl)
    x = _inputs(cfg, shape, tilt=tilt)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tp = _torch_tree(p)
    ref_route = _ref_routing(p, xj, cfg)
    jp = jax.tree.map(jnp.asarray, p)
    want = (r_moe.apply_moe(jp, xj, cfg) if impl == "shard_map"
            else r_moe._apply_moe_gspmd(jp, xj, cfg))
    return moe.route(tp, xt, tcfg), moe.apply_moe(tp, xt, tcfg), \
        ref_route, want


@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, dtype, impl):
    """Routing first (exact), then y and aux; ``shard_map`` is the
    production override, which without a mesh is the same function."""
    r, (y, aux), (idx, keep, cap), (ry, raux) = _run(arch, dtype, (2, 24),
                                                    impl=impl)
    assert r.cap == cap
    np.testing.assert_array_equal(r.idx.numpy(), idx, err_msg="idx")
    np.testing.assert_array_equal(r.keep.numpy(), keep, err_msg="keep")
    assert bool(r.keep.all())                 # 48 tokens never fill 128
    assert y.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    _close(y, ry, TOL[dtype])
    _close(aux, raux, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_drops_the_same_pairs(arch, dtype):
    """512 tokens pulled toward experts 0 and 1: their load passes the
    capacity of 128 and both drop the same (token, slot) pairs, the later
    ones in token-major order."""
    r, (y, aux), (idx, keep, cap), (ry, raux) = _run(
        arch, dtype, (2, 256), bias=8.0, tilt=4.0)
    np.testing.assert_array_equal(r.idx.numpy(), idx, err_msg="idx")
    np.testing.assert_array_equal(r.keep.numpy(), keep, err_msg="keep")
    load = np.bincount(idx.reshape(-1), minlength=16)
    assert cap == 128 and load.max() > 2 * cap
    dropped = ~keep
    assert dropped.sum() == sum(max(n - cap, 0) for n in load)
    # an expert keeps its first cap pairs in token-major order
    order = np.argsort(np.where(keep, 0, 1).reshape(-1), kind="stable")
    assert keep.reshape(-1)[order[:keep.sum()]].all()
    _close(y, ry, TOL[dtype])
    _close(aux, raux, TOL[dtype])


def test_padded_experts_are_never_chosen():
    """qwen2-moe's 60 experts pad to 64 (the smoke config's 6 to 16): no
    token goes to a padded expert, even with every real logit far below 0."""
    assert moe.padded_experts(60) == 64 and moe.padded_experts(160) == 160
    cfg, p, tcfg = _layer("qwen2-moe-a2.7b")
    assert p["router"].shape[-1] == moe.padded_experts(cfg.n_experts) == 16
    x = torch.from_numpy(_inputs(cfg, (4, 64), seed=3))
    tp = _torch_tree(p)
    r = moe.route(tp, x, tcfg)
    assert int(r.idx.max()) < cfg.n_experts
    tp["router"] = tp["router"] - 1e6
    assert int(moe.route(tp, x, tcfg).idx.max()) < cfg.n_experts


def test_equal_logits_go_to_the_lower_expert():
    """On exact ties the port picks as ``jax.lax.top_k`` does: the lower
    expert first."""
    cfg, p, tcfg = _layer("deepseek-v2-236b")
    p["router"][:, 1] = p["router"][:, 4]
    p["router"][:, 6] = p["router"][:, 2]
    x = _inputs(cfg, (2, 32), seed=4)
    idx, _, _ = _ref_routing(p, jnp.asarray(x), cfg)
    got = moe.route(_torch_tree(p), torch.from_numpy(x), tcfg).idx.numpy()
    np.testing.assert_array_equal(got, idx)
    assert np.isin(idx, [1, 4]).sum() > 0


def test_moe_routes_and_balances():
    """The port's counterpart of ``tests/test_models.py::
    test_moe_routes_and_balances``: its own init, bfloat16 input."""
    cfg = get_smoke("qwen2-moe-a2.7b")
    p = moe.init_moe(ParamInit(0, torch.device("cpu")), 1, cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 16, cfg.d_model))).to(torch.bfloat16)
    y, aux = moe.apply_moe(p, x, cfg)
    assert y.shape == x.shape and np.isfinite(float(aux))
    assert moe.padded_experts(60) == 64 and moe.padded_experts(160) == 160
