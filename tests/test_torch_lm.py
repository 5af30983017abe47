"""The port's LM substrate against the reference model.

For each dense-attention smoke config, and the two MoE configs
(deepseek-v2: MLA and the MoE; qwen2-moe: GQA and the MoE), the reference's
parameters are carried across with
``repro_torch.convert.lm_params_from_arrays``, and the same numpy tokens go
through both models: ``forward``, ``logits``, the prefill step (whose GQA
attention is K5's plain version here), the summed MoE aux loss, and
token-by-token ``serve_step`` (logits and every cache entry it wrote: K and
V, or MLA's latents; deepseek-v2's absorbed MLA decode in float32, R11).
Tolerances: 1e-4 (rtol and atol) in float32, the config with
``dtype="float32"``; in the config's bfloat16, where the two frameworks
round at other places, every element within 5e-2 of the tensor's largest
magnitude (an element near zero that is a sum of large bfloat16 terms
carries their rounding, so an elementwise rtol would not hold). Also: the
layers one by one, ``init_cache`` shapes (with ``kv_replicate_to``), the
init rule, the carried MoE parameters' layout, and the kinds not ported
yet.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.layers import mlp as r_mlp
from repro.layers import norms as r_norms
from repro.layers import rope as r_rope
from repro.models import Model as RModel
from repro.models import init_cache as r_init_cache
from repro.models.steps import make_prefill_step as r_make_prefill
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import lm_params_from_arrays
from repro_torch.layers import mlp, norms, rope
from repro_torch.models import Model, init_cache
from repro_torch.models.init import ParamInit
from repro_torch.models.lm import UNPORTED
from repro_torch.models.steps import make_prefill_step, make_serve_step

CPU = torch.device("cpu")
DENSE = ["phi3-mini-3.8b", "minitron-4b", "phi3-medium-14b",
         "command-r-plus-104b", "qwen2-vl-2b"]
MOE = ["deepseek-v2-236b", "qwen2-moe-a2.7b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 12


def _close(got, want, tol):
    got = np.asarray(got.float())
    want = np.asarray(want, np.float32)
    if tol == TOL["bfloat16"]:
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= tol * float(np.abs(want).max()), err
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str, absorb: bool = False):
    """Reference model and params, and the port's over the same params
    (``absorb``: MLA's weight-absorbed decode)."""
    over = dict(dtype=dtype, **({"mla_absorb": True} if absorb else {}))
    cfg = dataclasses.replace(r_get_smoke(arch), **over)
    rm = RModel(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke(arch), **over)
    tparams = lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rm, rparams, Model(tcfg), tparams


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


# -------------------------------------------------------------- layers ----

def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(1, 0.1, 16).astype(np.float32)
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           r_norms.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for got, want in zip(rope.rope_cos_sin(torch.from_numpy(pos), 16, 1e4),
                         r_rope.rope_cos_sin(jnp.asarray(pos), 16, 1e4)):
        _close(got, want, 1e-4)
    pos3 = np.stack([pos, pos + 1, pos + 2])
    tc, ts = rope.mrope_cos_sin(torch.from_numpy(pos3), 16, 1e6, (2, 3, 3))
    jc, js = r_rope.mrope_cos_sin(jnp.asarray(pos3), 16, 1e6, (2, 3, 3))
    _close(tc, jc, 1e-4)
    _close(rope.apply_rope(torch.from_numpy(x), tc, ts),
           r_rope.apply_rope(jnp.asarray(x), jc, js), 1e-4)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(1)
    p = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in (
        ("wi_gate", (16, 32)), ("wi_up", (16, 32)), ("wo", (32, 16)))}
    x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    _close(mlp.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), act),
           r_mlp.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), act), 1e-5)


# --------------------------------------------------------------- model ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_logits_and_prefill_match(arch, dtype):
    rm, rparams, tm, tparams = _models(arch, dtype)
    toks = _tokens(rm.cfg)
    rx, raux = rm.forward(rparams, {"tokens": jnp.asarray(toks)})
    tx, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert tx.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    if arch in DENSE:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0
        _close(aux, raux, TOL[dtype])
    _close(tx, rx, TOL[dtype])
    _close(tm.logits(tparams, tx), rm.logits(rparams, rx), TOL[dtype])
    want = r_make_prefill(rm)(rparams, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tm)(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, tm.cfg.vocab)
    _close(got, want, TOL[dtype])


def _decode_matches(arch, dtype, absorb=False):
    """Token-by-token ``serve_step`` of both models: logits at every
    position, then every cache entry they wrote."""
    rm, rparams, tm, tparams = _models(arch, dtype, absorb)
    toks = _tokens(rm.cfg, seed=1)
    rcache = r_init_cache(rm.cfg, B, 16)
    tcache = init_cache(tm.cfg, B, 16, device="cpu")
    rstep = jax.jit(rm.serve_step)
    tstep = make_serve_step(tm)
    for t in range(S):
        rl, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = tstep(tparams, tcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        _close(tl, rl, TOL[dtype])
    names = set()
    for seg, blks in rcache.items():
        for blk, entry in blks.items():
            assert set(tcache[seg][blk]) == set(entry)
            for name, want in entry.items():
                _close(tcache[seg][blk][name], want, TOL[dtype])
                names.add(name)
    assert names == ({"c", "k_rope"} if rm.cfg.attn_type == "mla"
                     else {"k", "v"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_serve_step_matches_token_by_token(arch, dtype):
    """Decode logits at every position and the cache they leave behind
    (deepseek-v2: the naive MLA decode)."""
    _decode_matches(arch, dtype)


def test_absorbed_mla_decode_matches_token_by_token():
    """deepseek-v2 with the weight-absorbed MLA decode (the production
    override), float32. In bfloat16 the absorbed form rounds its latent
    scores to bfloat16, as the reference does, and the near-one-hot softmax
    of the random model amplifies the one-ulp differences the two
    frameworks' bfloat16 products leave upstream (ROADMAP queue 3, R11);
    ``tests/test_torch_mla.py`` holds that path to the reference in
    bfloat16 on identical inputs."""
    _decode_matches("deepseek-v2-236b", "float32", absorb=True)


def test_serve_step_with_replicated_kv_heads():
    """``kv_replicate_to`` widens the cache's heads; decode still matches."""
    cfg = dataclasses.replace(r_get_smoke("minitron-4b"), dtype="float32",
                              kv_replicate_to=4)
    rm = RModel(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(2))
    tm = Model(dataclasses.replace(get_smoke("minitron-4b"),
                                   dtype="float32", kv_replicate_to=4))
    tparams = lm_params_from_arrays(tm.cfg, jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    toks = _tokens(cfg, seed=2)
    rcache = r_init_cache(cfg, B, 8)
    tcache = init_cache(tm.cfg, B, 8, device="cpu")
    for t in range(4):
        rl, rcache = rm.serve_step(rparams, rcache,
                                   jnp.asarray(toks[:, t:t + 1]), t)
        tl, tcache = tm.serve_step(tparams, tcache,
                                   torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl, rl, TOL["float32"])
    _close(tcache["seg0"]["blk0"]["k"], rcache["seg0"]["blk0"]["k"],
           TOL["float32"])


@pytest.mark.parametrize("production", [False, True])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_init_cache_shapes_match(arch, production):
    """Full-width configs; ``production`` turns ``kv_replicate_to`` (or
    deepseek-v2's absorbed decode, which keeps the latent cache) on."""
    from repro.configs import get_config as r_get_config
    want = r_init_cache(r_get_config(arch, production=production), 3, 40,
                        abstract=True)
    got = init_cache(get_config(arch, production=production), 3, 40,
                     device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]), got))


def test_init_follows_the_reference_rule():
    """Per-leaf std of the port's draws against the rule and against the
    reference's own draws: normal x 0.02, ``scaled`` x 1/sqrt(the stacked
    layer count), ones."""
    cfg = dataclasses.replace(r_get_smoke("minitron-4b"), n_layers=8)
    rparams, _ = RModel(cfg).init(jax.random.PRNGKey(0))
    tparams = Model(dataclasses.replace(get_smoke("minitron-4b"),
                                        n_layers=8)).init(3, device="cpu")
    rblk, tblk = rparams["seg0"]["blk0"], tparams["seg0"]["blk0"]
    assert len(tblk) == 8
    cases = [(rparams["embed"], tparams["embed"], 0.02),
             (rparams["lm_head"], tparams["lm_head"], 0.02),
             (rblk["mixer"]["wq"], torch.stack([p["mixer"]["wq"]
                                                for p in tblk]), 8 ** -0.5),
             (rblk["mlp"]["wo"], torch.stack([p["mlp"]["wo"] for p in tblk]),
              8 ** -0.5)]
    for ref, got, rule in cases:
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        assert abs(float(got.std()) / rule - 1) < 0.03
        assert abs(float(np.std(np.asarray(ref))) / rule - 1) < 0.03
    assert all(torch.equal(p["ln1"], torch.ones(cfg.d_model)) for p in tblk)
    again = Model(dataclasses.replace(get_smoke("minitron-4b"), n_layers=8)
                  ).init(3, device="cpu")
    assert torch.equal(again["embed"], tparams["embed"])     # seeded


@pytest.mark.parametrize("arch", MOE)
def test_carried_params_have_the_port_init_layout(arch):
    """``lm_params_from_arrays`` unstacks the reference's MLA and MoE
    leaves (``[n, E, d, f]`` experts, the nested ``shared`` MLP) into the
    very tree, shapes and dtypes the port's own init draws."""
    _, _, tm, carried = _models(arch, "float32")
    drawn = tm.init(1, device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return tuple(tree.shape), tree.dtype
    assert layout(carried) == layout(drawn)
    moe_blk = carried[f"seg{len(tm.segments) - 1}"]["blk0"][0]["mlp"]
    assert moe_blk["w_gate"].shape[0] == 16 and "wi_gate" in moe_blk["shared"]


def test_param_init_rejects_unknown_rule():
    with pytest.raises(ValueError, match="unknown init"):
        ParamInit(0, CPU).param((2, 2), "uniform")


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in DENSE + MOE])
def test_unported_kinds_raise(arch):
    cfg = get_smoke(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        Model(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        init_cache(cfg, 1, 8, device="cpu")


def test_patch_embeds_raise():
    tm = Model(get_smoke("qwen2-vl-2b"))
    params = tm.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="patch"):
        tm.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                            "patch_embeds": torch.zeros(1, 2, 64)})
    assert set(UNPORTED) >= {"rwkv", "rglru", "wattn", "frames",
                             "patch_embeds"}


def test_model_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = Model(get_smoke("minitron-4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tm.cfg, 1, 8)
