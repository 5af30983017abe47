"""The port's LM substrate against the reference model.

For each dense-attention smoke config, the two MoE configs (deepseek-v2:
MLA and the MoE; qwen2-moe: GQA and the MoE) and the two recurrent ones
(rwkv6: RWKV time and channel mix; recurrentgemma at 5 layers, so that its
remainder segment is covered: the RG-LRU and the ``wattn`` ring buffer),
the reference's
parameters are carried across with
``repro_torch.convert.lm_params_from_arrays``, and the same numpy tokens go
through both models: ``forward``, ``logits``, the prefill step (whose GQA
attention is K5's plain version here), the summed MoE aux loss, and
token-by-token ``serve_step`` (logits and every cache entry it wrote: K and
V, or MLA's latents, RWKV's and RG-LRU's state and the ring's ``kpos``;
deepseek-v2's absorbed MLA decode in float32, R11). The recurrent configs'
decode is held to the reference's ``serve_step`` run op by op: under
``jax.jit`` XLA keeps fused bfloat16 elementwise chains in float32 (its
excess precision), where the reference's own ops and the port round each
op to bfloat16, and recurrentgemma's bfloat16 logits then move by up to 7%
of their scale between the two.
Tolerances: 1e-4 (rtol and atol) in float32, the config with
``dtype="float32"``; in the config's bfloat16, where the two frameworks
round at other places, every element within 5e-2 of the tensor's largest
magnitude (an element near zero that is a sum of large bfloat16 terms
carries their rounding, so an elementwise rtol would not hold). Also: the
layers one by one, ``init_cache`` shapes (with ``kv_replicate_to``), the
init rule, the carried MoE parameters' layout, and hubert's frames and
qwen2-vl's patch embeddings running. The ring buffer past its wrap point, as in
``tests/test_models.py::test_griffin_ring_buffer_wraparound``, is held to
the reference's decode and, in float32, to the windowed prefill.
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
from repro_torch.models.steps import make_prefill_step, make_serve_step

CPU = torch.device("cpu")
DENSE = ["phi3-mini-3.8b", "minitron-4b", "phi3-medium-14b",
         "command-r-plus-104b", "qwen2-vl-2b"]
MOE = ["deepseek-v2-236b", "qwen2-moe-a2.7b"]
RECURRENT = ["rwkv6-1.6b", "recurrentgemma-9b"]
LAYERS = {"recurrentgemma-9b": 5}     # two patterns and a remainder
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
    over = dict(dtype=dtype, **({"mla_absorb": True} if absorb else {}),
                **({"n_layers": LAYERS[arch]} if arch in LAYERS else {}))
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
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_forward_logits_and_prefill_match(arch, dtype):
    rm, rparams, tm, tparams = _models(arch, dtype)
    toks = _tokens(rm.cfg)
    rx, raux = rm.forward(rparams, {"tokens": jnp.asarray(toks)})
    tx, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert tx.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    if arch in MOE:
        assert float(aux) > 0.0
        _close(aux, raux, TOL[dtype])
    else:
        assert float(aux) == 0.0
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
    # the recurrent configs against the op-by-op reference (module
    # docstring); the others against the jitted step
    eager = arch in RECURRENT
    rstep = rm.serve_step if eager else jax.jit(rm.serve_step)
    tstep = make_serve_step(tm)
    for t in range(S):
        rl, rcache = rstep(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                           t if eager else jnp.int32(t))
        tl, tcache = tstep(tparams, tcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        _close(tl, rl, TOL[dtype])
    return _same_caches(tcache, rcache, TOL[dtype])


def _same_caches(tcache, rcache, tol) -> set:
    """Every entry of the reference's cache, nested ones included, against
    the port's (the ring's ``kpos`` exactly); -> the leaf names."""
    names = set()
    for path, want in jax.tree_util.tree_flatten_with_path(rcache)[0]:
        keys = [p.key for p in path]
        got = tcache
        for key in keys:
            got = got[key]
        if keys[-1] == "kpos":
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, tol)
        names.add("/".join(keys[2:]))
    assert len(jax.tree.leaves(rcache)) == len(jax.tree.leaves(tcache))
    return names


CACHE_NAMES = {"mla": {"c", "k_rope"}, "gqa": {"k", "v"},
               "rwkv6-1.6b": {"time/shift", "time/wkv", "channel_shift"},
               "recurrentgemma-9b": {"conv", "h", "k", "v", "kpos"}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_serve_step_matches_token_by_token(arch, dtype):
    """Decode logits at every position and the cache they leave behind
    (deepseek-v2: the naive MLA decode)."""
    names = _decode_matches(arch, dtype)
    cfg = get_smoke(arch)
    assert names == (CACHE_NAMES[arch] if arch in CACHE_NAMES
                     else CACHE_NAMES[cfg.attn_type])


def test_ring_buffer_wraparound_matches_reference():
    """``test_griffin_ring_buffer_wraparound``'s case (recurrentgemma's
    smoke config, window 16, 24 positions, so slots 0-7 are written twice)
    in float32: the port's decode logits and its cache, ``kpos`` included,
    against the reference's decode, and the decode against the port's own
    windowed prefill."""
    rm, rparams, tm, tparams = _models("recurrentgemma-9b", "float32")
    t_len = 3 * tm.cfg.window // 2
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab, (B, t_len)
                                             ).astype(np.int32)
    rcache = r_init_cache(rm.cfg, B, t_len + 8)
    tcache = init_cache(tm.cfg, B, t_len + 8, device="cpu")
    got = []
    for t in range(t_len):
        rl, rcache = rm.serve_step(rparams, rcache,
                                   jnp.asarray(toks[:, t:t + 1]), t)
        tl, tcache = tm.serve_step(tparams, tcache,
                                   torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl, rl, TOL["float32"])
        got.append(tl)
    _same_caches(tcache, rcache, TOL["float32"])
    kpos = tcache["seg0"]["blk2"]["kpos"][0]
    assert kpos.tolist() == list(range(16, 24)) + list(range(8, 16))
    x, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _close(torch.stack(got, 1), tm.logits(tparams, x), TOL["float32"])


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
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_init_cache_shapes_match(arch, production):
    """Full-width configs; ``production`` turns ``kv_replicate_to`` (or
    deepseek-v2's absorbed decode, which keeps the latent cache) on;
    recurrentgemma's ``wattn`` cache keeps its one KV head under it."""
    from repro.configs import get_config as r_get_config
    want = r_init_cache(r_get_config(arch, production=production), 3, 40,
                        abstract=True)
    got = init_cache(get_config(arch, production=production), 3, 40,
                     device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]), got))
    if arch == "recurrentgemma-9b":
        ring = got["seg0"]["blk2"]
        assert ring["k"].shape[-2] == 1
        assert bool((ring["kpos"] == -10**9).all())


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


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layout(v) for v in tree]
    return tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("arch", MOE)
def test_carried_params_have_the_port_init_layout(arch):
    """``lm_params_from_arrays`` unstacks the reference's MLA and MoE
    leaves (``[n, E, d, f]`` experts, the nested ``shared`` MLP) into the
    very tree, shapes and dtypes the port's own init draws."""
    _, _, tm, carried = _models(arch, "float32")
    drawn = tm.init(1, device="cpu")
    assert _layout(carried) == _layout(drawn)
    moe_blk = carried[f"seg{len(tm.segments) - 1}"]["blk0"][0]["mlp"]
    assert moe_blk["w_gate"].shape[0] == 16 and "wi_gate" in moe_blk["shared"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_carried_recurrent_params_have_the_port_init_layout(arch):
    """RWKV's ``mu`` ``[5, d]`` and ``u`` ``[H, D]``, the channel mix under
    ``mlp``, the RG-LRU's conv and gates: the carried tree is the one the
    port draws, and the draws follow the reference's rule (``normal`` x
    0.02, ``scaled`` x 1/sqrt(the stacked layer count), ones)."""
    _, rparams, tm, carried = _models(arch, "float32")
    drawn = tm.init(1, device="cpu")
    assert _layout(carried) == _layout(drawn)
    blk = drawn["seg0"]["blk0"][0]
    n = tm.segments[0].repeats
    if arch == "rwkv6-1.6b":
        assert blk["mixer"]["mu"].shape == (5, tm.cfg.d_model)
        assert set(blk["mlp"]) == {"mu", "wk", "wv", "wr"}
        scaled, normal = blk["mixer"]["wr"], blk["mixer"]["mu"]
    else:
        assert blk["mixer"]["conv_w"].shape == (4, tm.cfg.rnn_width)
        assert torch.equal(blk["mixer"]["lam"], torch.ones(64))
        scaled, normal = blk["mixer"]["wa"], blk["mixer"]["conv_w"]
    assert abs(float(scaled.std()) * n ** 0.5 - 1) < 0.05
    assert abs(float(normal.std()) / 0.02 - 1) < 0.1


def test_param_init_rejects_unknown_rule():
    with pytest.raises(ValueError, match="unknown init"):
        ParamInit(0, CPU).param((2, 2), "uniform")


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in DENSE + MOE + RECURRENT])
def test_unported_kinds_raise(arch):
    """The configs outside the families above (hubert's frames frontend)
    now run: the model, its cache and a forward on frames; only a kind the
    reference lacks raises."""
    cfg = get_smoke(arch)
    tm = Model(cfg)
    cache = init_cache(cfg, 1, 8, device="cpu")
    assert cache["seg0"]["blk0"]["k"].shape[:3] == (cfg.n_layers, 1, 8)
    params = tm.init(0, device="cpu")
    x, _ = tm.forward(params, {"frames": torch.ones(1, 4, cfg.d_model)})
    assert tuple(x.shape) == (1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="frontend"):
        Model(dataclasses.replace(cfg, frontend="pixels"))


def test_patch_embeds_raise():
    """Patch embeddings replace the first positions' token embeddings (held
    to the reference in ``tests/test_torch_frontends.py``); only ones that
    do not fit raise, as the reference's ``dynamic_update_slice``."""
    tm = Model(get_smoke("qwen2-vl-2b"))
    params = tm.init(0, device="cpu")
    x, _ = tm.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                               "patch_embeds": torch.zeros(1, 2, 64)})
    assert tuple(x.shape) == (1, 4, 64)
    with pytest.raises(ValueError, match="patch"):
        tm.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                            "patch_embeds": torch.zeros(1, 6, 64)})


def test_model_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = Model(get_smoke("minitron-4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tm.cfg, 1, 8)
