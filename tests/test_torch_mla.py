"""The port's Multi-head Latent Attention against the reference.

The reference draws one MLA layer of deepseek-v2's smoke config, with its
``q_lora`` and without; the port gets the same arrays, and the same numpy
input goes through ``repro_torch.layers.mla.apply_mla`` and
``repro.layers.mla.apply_mla``: prefill (no cache), and decode step by step
in both forms, naive (``_project_kv`` over the whole cache) and absorbed
(``cfg.mla_absorb``), each step's output and the latent cache (``c``,
``k_rope``) it leaves. Tolerances: in float32 rtol 1e-4 and atol 1e-4 of
the tensor's largest magnitude; in bfloat16 every element within 5e-2 of
that magnitude (the layer's output is not normalised: with the reference's
init of one stacked layer it is a sum of large terms). Also the port's
counterpart of ``tests/test_models.py::
test_mla_absorbed_decode_matches_naive``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.layers import mla as r_mla
from repro.parallel import ParamCollector
from repro_torch.configs import get_smoke
from repro_torch.layers import mla
from repro_torch.models import Model, init_cache
from repro_torch.models.steps import make_serve_step
from test_torch_moe import TOL, _close

ARCH = "deepseek-v2-236b"
B, S = 2, 10


def _layer(q_lora: bool, absorb: bool = False, seed: int = 0):
    """Reference and port configs, the reference's one-layer params as
    jnp, and the same arrays as torch tensors."""
    over = dict(mla_absorb=absorb, **({} if q_lora else {"q_lora": 0}))
    cfg = dataclasses.replace(r_get_smoke(ARCH), **over)
    tcfg = dataclasses.replace(get_smoke(ARCH), **over)
    p = r_mla.init_mla(ParamCollector(), 1, cfg, jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda a: np.array(a[0]), p)
    assert ("wq_a" in p) == q_lora and ("wq" in p) != q_lora
    return (cfg, jax.tree.map(jnp.asarray, p), tcfg,
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(cfg, dtype, seed=0):
    x = np.random.default_rng(seed).normal(0, 1, (B, S, cfg.d_model)
                                           ).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(getattr(torch, dtype))


def _pos(t0, n):
    pos = np.broadcast_to(np.arange(t0, t0 + n, dtype=np.int32), (B, n))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_prefill_matches_reference(q_lora, dtype):
    cfg, jp, tcfg, tp = _layer(q_lora)
    xj, xt = _x(cfg, dtype)
    pj, pt = _pos(0, S)
    want, wc = r_mla.apply_mla(jp, xj, cfg, pos_ids=pj)
    got, gc = mla.apply_mla(tp, xt, tcfg, pos_ids=pt)
    assert wc is None and gc is None and got.dtype == xt.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_decode_matches_reference_step_by_step(q_lora, absorb, dtype):
    """Each step's output, and the cache's ``c`` and ``k_rope`` after the
    last step (written in place by the port, returned by the reference)."""
    cfg, jp, tcfg, tp = _layer(q_lora, absorb)
    xj, xt = _x(cfg, dtype, seed=1)
    sc = S + 6
    jdt = xj.dtype
    rcache = {"c": jnp.zeros((B, sc, cfg.kv_lora), jdt),
              "k_rope": jnp.zeros((B, sc, cfg.rope_head_dim), jdt)}
    tcache = {"c": torch.zeros((B, sc, cfg.kv_lora), dtype=xt.dtype),
              "k_rope": torch.zeros((B, sc, cfg.rope_head_dim),
                                    dtype=xt.dtype)}
    step = jax.jit(lambda p, x, pos, c, t: r_mla.apply_mla(
        p, x, cfg, pos_ids=pos, cache=c, write_pos=t))
    for t in range(S):
        pj, pt = _pos(t, 1)
        want, rcache = step(jp, xj[:, t:t + 1], pj, rcache, jnp.int32(t))
        got, out = mla.apply_mla(tp, xt[:, t:t + 1], tcfg, pos_ids=pt,
                                 cache=tcache, write_pos=t)
        assert out["c"] is tcache["c"]          # in place
        _close(got, want, TOL[dtype])
    for name in ("c", "k_rope"):
        _close(tcache[name], rcache[name], TOL[dtype])
    assert not tcache["c"][:, S:].any()


@pytest.mark.parametrize("q_lora", [True, False])
def test_absorbed_decode_equals_naive_and_prefill(q_lora):
    """float32: the absorbed decode, the naive decode and the prefill give
    one function (the weight absorption reassociates exact products)."""
    outs = {}
    for absorb in (False, True):
        _, _, tcfg, tp = _layer(q_lora, absorb, seed=2)
        _, xt = _x(tcfg, "float32", seed=2)
        cache = {"c": torch.zeros((B, S, tcfg.kv_lora)),
                 "k_rope": torch.zeros((B, S, tcfg.rope_head_dim))}
        outs[absorb] = torch.cat([mla.apply_mla(
            tp, xt[:, t:t + 1], tcfg, pos_ids=_pos(t, 1)[1], cache=cache,
            write_pos=t)[0] for t in range(S)], 1)
    full, _ = mla.apply_mla(tp, xt, tcfg, pos_ids=_pos(0, S)[1])
    _close(outs[True], outs[False], TOL["float32"])
    _close(outs[False], full, TOL["float32"])


def test_mla_absorbed_decode_matches_naive():
    """The port's counterpart of ``tests/test_models.py::
    test_mla_absorbed_decode_matches_naive``: the model in its bfloat16,
    its own init, absorbed against naive decode logits."""
    base = get_smoke(ARCH)
    toks = np.random.default_rng(0).integers(0, base.vocab, (B, 8)
                                             ).astype(np.int32)
    outs = {}
    for absorb in (False, True):
        cfg = dataclasses.replace(base, mla_absorb=absorb)
        m = Model(cfg)
        params = m.init(0, device="cpu")
        cache = init_cache(cfg, B, 64, device="cpu")
        step = make_serve_step(m)
        got = []
        for t in range(8):
            lg, cache = step(params, cache,
                             torch.from_numpy(toks[:, t:t + 1]), t)
            got.append(lg.float().numpy())
        outs[absorb] = np.stack(got, 1)
    np.testing.assert_allclose(outs[True], outs[False], rtol=0.05, atol=0.05)
