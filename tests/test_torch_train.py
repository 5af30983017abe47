"""Training in the port against the reference: the loss, its gradients,
the train step with gradient accumulation, remat, and K5's autograd
function.

Every smoke config of the registry runs ``loss_fn`` through both models in
float32 on the same numpy batch (the reference's parameters carried across
with ``convert.lm_params_from_arrays``; frames for hubert); the loss within
1e-4 (rtol and atol). The gradients of the dense (qwen2-vl, M-RoPE), MoE
(qwen2-moe), MLA (deepseek-v2), RWKV (rwkv6), RG-LRU (recurrentgemma) and
frames (hubert) configs are held to ``jax.grad``'s: every element of a
leaf within 1e-3 of that leaf's largest magnitude (the two frameworks sum
in other orders, and K5's plain version blocks the keys by 256 where the
reference's jnp attention takes chunks of 1,024). Three ``make_train_step``
steps with ``grad_accum`` 2 hold the losses within 1e-4 and all but one
parameter element in 1,000 within 1e-5 (atol) of the reference's; every
element stays within 2 lr a step taken. AdamW moves an element by about lr
a step whatever its gradient's size, so an element whose gradient is near
zero turns the two frameworks' summation-order difference into a move of
up to that scale (one element in 8,192 differed by 2.3e-4 after three
steps at lr 1e-3). Remat ``"full"`` and ``"dots"`` give the gradients of
no remat, bit for bit on the CPU; ``"dots"`` saves the products the
reference's ``dots_with_no_batch_dims_saveable`` saves (compared by their
element counts, the layouts differing), and a forward that takes no
gradient is not rematerialised. ``K5Attention``'s gradients equal the plain
``flash_attention``'s under autograd within 1e-5, and a causal backward
that skips the fully masked key chunks equals, bit for bit, one that reads
every key.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax.extend import core as jcore
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models import Model as RModel
from repro.models.steps import init_train_state as r_init_train_state
from repro.models.steps import loss_fn as r_loss_fn
from repro.models.steps import make_train_step as r_make_train_step
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.convert import (lm_arrays_from_params, lm_params_from_arrays,
                                 train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.layers import attention as attn_mod
from repro_torch.layers.attention import (K5Attention, attention_backward,
                                          flash_attention)
from repro_torch.layers.grad import taking_grad
from repro_torch.layers.scan import linear_scan
from repro_torch.models import Model
from repro_torch.models import lm as lm_mod
from repro_torch.models import steps as steps_mod
from repro_torch.models.steps import (loss_and_grad, loss_fn, make_eval_step,
                                      make_train_step)
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import leaves

GRAD_ARCHS = ["qwen2-vl-2b", "qwen2-moe-a2.7b", "deepseek-v2-236b",
              "rwkv6-1.6b", "recurrentgemma-9b", "hubert-xlarge"]
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _models(arch: str, **over):
    cfg = dataclasses.replace(r_get_smoke(arch), dtype="float32", **over)
    rm = RModel(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    return rm, rparams, Model(tcfg)


def _port_params(arch: str, **over):
    rm, rparams, tm = _models(arch, **over)
    return lm_params_from_arrays(tm.cfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")


def _batch(cfg, seed: int = 0, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    out["labels"][0, :3] = -1                  # masked labels count nothing
    if cfg.frontend == "frames":
        out["frames"] = rng.normal(0, 1, (b, S, cfg.d_model)).astype(
            np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tree_like(flat: list, like):
    """A list of leaves in ``leaves`` order back into ``like``'s shape."""
    it = iter(flat)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return next(it)
    return fill(like)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_matches(arch):
    rm, rparams, tm = _models(arch)
    batch = _batch(rm.cfg)
    want = jax.jit(functools.partial(r_loss_fn, rm))(rparams, _jax(batch))
    got = loss_fn(tm, _port_params(arch), _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-4)
    assert float(make_eval_step(tm)(_port_params(arch), _torch(batch))) \
        == float(got)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax_grad(arch):
    rm, rparams, tm = _models(arch)
    batch = _batch(rm.cfg, seed=1)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        functools.partial(r_loss_fn, rm)))(rparams, _jax(batch))
    tparams = _port_params(arch)
    loss, grads = loss_and_grad(tm, tparams, _torch(batch))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-4,
                               atol=1e-4)
    assert not any(t.requires_grad for t in leaves(tparams))
    got = lm_arrays_from_params(tm.cfg, _tree_like(grads, tparams))
    flat_want = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    for path, want in flat_want:
        g = got
        for key in path:
            g = g[key.key]
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        err = float(np.abs(g - want).max())
        assert err <= 1e-3 * max(scale, 1e-12), (jax.tree_util.keystr(path),
                                                  err, scale)


def test_train_steps_with_grad_accum_match():
    """Three steps of ``make_train_step`` at ``grad_accum`` 2 (the batch of
    4 split into two micro-batches of 2) from the same state: losses and
    the parameters and moments after each step."""
    arch = "qwen2-vl-2b"
    rm, _, tm = _models(arch, grad_accum=2)
    rparams, ropt, _ = r_init_train_state(rm, jax.random.PRNGKey(1))
    r_step = jax.jit(r_make_train_step(rm, lr=1e-3))
    tree = {"params": jax.tree.map(np.asarray, rparams),
            "opt": jax.tree.map(np.asarray, ropt)}
    params, opt = train_state_from_arrays(tm.cfg, tree, device="cpu")
    step = make_train_step(tm, lr=1e-3)
    for i in range(3):
        batch = _batch(rm.cfg, seed=10 + i, b=4)
        rloss, rparams, ropt = r_step(rparams, ropt, _jax(batch))
        loss, params, opt = step(params, opt, _torch(batch))
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-4,
                                   atol=1e-4)
        got = train_state_to_arrays(tm.cfg, params, opt)
        assert int(got["opt"].step) == int(ropt.step) == i + 1
        diff = np.concatenate([
            np.abs(g - np.asarray(w)).ravel()
            for g, w in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(rparams))])
        assert diff.max() <= 2 * 1e-3 * (i + 1), diff.max()
        assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).sum()


def test_grad_accum_averages_micro_batches(monkeypatch):
    """``grad_accum`` 2 over a batch equals the mean of the two halves'
    gradients taken one at a time (the port against itself)."""
    arch = "phi3-mini-3.8b"
    tm2 = _models(arch, grad_accum=2)[2]
    tm1 = _models(arch)[2]
    batch = _torch(_batch(tm1.cfg, seed=3, b=4))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    p1, p2 = _port_params(arch), _port_params(arch, grad_accum=2)
    g = [loss_and_grad(tm1, p1, h)[1] for h in halves]
    want = [(a.float() + b.float()) / 2 for a, b in zip(*g)]
    grads = []

    def capture(gr, state, params, lr):
        grads.extend(gr)
        return params, state
    monkeypatch.setattr(steps_mod, "adamw_update", capture)
    make_train_step(tm2)(p2, adamw_init(p2), batch)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "recurrentgemma-9b"])
def test_remat_modes_give_the_same_gradients(arch):
    """``remat`` "full" and "dots" recompute what "none" keeps; on the CPU
    the recomputed layers give the same numbers, so the gradients are
    identical."""
    out = {}
    for mode in ("none", "full", "dots"):
        tm = _models(arch, remat=mode)[2]
        batch = _torch(_batch(tm.cfg, seed=2))
        out[mode] = loss_and_grad(tm, _port_params(arch, remat=mode),
                                  batch)
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0])
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rows", [16, 1024])
def test_k5_function_gradients_match_plain(causal, rows):
    """``K5Attention`` (K5's plain version forward on the CPU) against the
    plain ``flash_attention`` differentiated by autograd, the backward in
    row blocks of 16 (several) and 1,024 (one)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               for shape in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    dout = torch.from_numpy(rng.normal(0, 1, (2, 40, 4, 16)).astype(
        np.float32))
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*ref, causal=causal, q_offset=0)
    want = torch.autograd.grad(out, ref, dout)
    got = attention_backward(q, k, v, dout, causal=causal, rows=rows)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    y = K5Attention.apply(*ins, causal)
    torch.testing.assert_close(y, out.detach(), rtol=1e-5, atol=1e-5)
    fn = torch.autograd.grad(y, ins, dout)
    for a, b in zip(fn, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _reference_saved_products(jaxpr, mult: int = 1, inside: bool = False,
                              out: list | None = None) -> list:
    """Element counts of the products without batch dims inside the
    reference's ``dots_with_no_batch_dims_saveable`` checkpoints (a scan
    body's once a layer)."""
    out = [] if out is None else out
    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general" and inside \
                and not e.params["dimension_numbers"][1][0]:
            out += [math.prod(e.outvars[0].aval.shape)] * mult
        m = mult * e.params["length"] if name == "scan" else mult
        ins = inside or (name in ("checkpoint", "remat", "remat2")
                         and e.params.get("policy") is policy)
        for v in e.params.values():
            for j in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(j, jcore.ClosedJaxpr):
                    _reference_saved_products(j.jaxpr, m, ins, out)
                elif isinstance(j, jcore.Jaxpr):
                    _reference_saved_products(j, m, ins, out)
    return out


def _product_numel(op, args) -> int:
    aten = torch.ops.aten
    if op is aten.addmm.default:
        return args[1].shape[0] * args[2].shape[1]
    if op is aten.mm.default:
        return args[0].shape[0] * args[1].shape[1]
    return args[0].shape[0] * args[0].shape[1] * args[1].shape[2]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-236b",
                                  "qwen2-vl-2b"])
def test_remat_dots_saves_what_the_reference_saves(arch, monkeypatch):
    """Remat ``"dots"`` on an MoE, an MLA and a dense config: the products
    the port's policy saves in the forward, against the products without
    batch dims in the reference's checkpointed layer bodies (the MoE
    experts' products and the attention scores are recomputed by both)."""
    rm, rparams, tm = _models(arch, remat="dots")
    batch = _batch(rm.cfg, seed=3)
    jaxpr = jax.make_jaxpr(functools.partial(r_loss_fn, rm))(
        rparams, _jax(batch))
    want = sorted(_reference_saved_products(jaxpr.jaxpr))
    saved, real = [], lm_mod._dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and lm_mod.saves_product(op, args):
            saved.append(_product_numel(op, args))
        return decision
    monkeypatch.setattr(lm_mod, "_dots_policy", recording)
    loss_and_grad(tm, _port_params(arch, remat="dots"), _torch(batch))
    assert want and sorted(saved) == want


def test_forward_without_a_gradient_is_not_rematerialised(monkeypatch):
    """``taking_grad`` decides training: a forward with nothing to
    differentiate (grad mode on, no leaf requiring a gradient) wraps no
    layer, a gradient taken wraps each one."""
    wrapped = []
    real = lm_mod._remat

    def counting(fn, mode):
        wrapped.append(mode)
        return real(fn, mode)
    monkeypatch.setattr(lm_mod, "_remat", counting)
    tm = _models("qwen2-vl-2b", remat="full")[2]
    params = _port_params("qwen2-vl-2b", remat="full")
    batch = _torch(_batch(tm.cfg, seed=5))
    x, _ = tm.forward(params, batch)
    assert wrapped == [] and not x.requires_grad
    loss_and_grad(tm, params, batch)
    assert wrapped == ["full"] * tm.cfg.n_layers
    t = torch.zeros(2, requires_grad=True)
    assert taking_grad({"a": [torch.zeros(1), (t,)]})
    assert not taking_grad({"a": [torch.zeros(1)]})
    with torch.no_grad():
        assert not taking_grad(t)


@pytest.mark.parametrize("skv", [3072, 2500])
def test_causal_backward_skips_masked_key_chunks(skv, monkeypatch):
    """A causal row block reads the keys up to the end of the last key
    chunk it can see (3,072 keys: chunks of 1,024, blocks read 1,024,
    2,048, 3,072; 2,500 keys: chunks of 1,250, blocks read 1,250, 2,500,
    2,500), and its gradients equal, bit for bit, those of the same blocks
    over every key."""
    rng = np.random.default_rng(6)
    q, k, v, dout = (torch.from_numpy(rng.normal(0, 1, (1, skv, h, 8))
                                      .astype(np.float32))
                     for h in (2, 1, 1, 2))
    want = [torch.zeros_like(t) for t in (q, k, v)]
    for r0 in range(0, skv, 1024):
        ins = [q[:, r0:r0 + 1024].clone().requires_grad_(),
               k.clone().requires_grad_(), v.clone().requires_grad_()]
        out = flash_attention(*ins, causal=True, q_offset=r0)
        g = torch.autograd.grad(out, ins, dout[:, r0:r0 + 1024])
        want[0][:, r0:r0 + 1024] = g[0]
        want[1] += g[1]
        want[2] += g[2]
    read = []
    real = attn_mod.flash_attention

    def recording(q, k, v, **kw):
        read.append(k.shape[1])
        return real(q, k, v, **kw)
    monkeypatch.setattr(attn_mod, "flash_attention", recording)
    got = attention_backward(q, k, v, dout, causal=True)
    chunk = skv // max(skv // 1024, 1)
    assert read == [min(skv, -(-min(r0 + 1024, skv) // chunk) * chunk)
                    for r0 in range(0, skv, 1024)]
    assert read[0] < skv
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("a_shape", [(2, 37, 3, 4, 1), (2, 37, 3, 4, 4)])
def test_scan_forms_give_the_same_numbers(a_shape):
    """``linear_scan``'s in-place steps (no gradient) and its out-of-place
    steps (a gradient taken) are the same products in the same order: the
    same numbers, bit for bit, with a broadcast decay and a full one."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, a_shape).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, 37, 3, 4, 4)).astype(
        np.float32))
    plain = linear_scan(a, b, dim=1)
    bb = b.clone().requires_grad_()
    graded = linear_scan(a, bb, dim=1)
    assert graded.requires_grad and torch.equal(graded.detach(), plain)
    (g,) = torch.autograd.grad(graded.sum(), bb)
    assert torch.isfinite(g).all()
