"""The frames and patch-embedding frontends and K5 at head dim 80, in the
port against the reference.

hubert's forward with frame embeddings (``in_proj``, bidirectional) and
qwen2-vl's with patch embeddings over the first positions (M-RoPE ids
text-mode) go through both models on the same numpy inputs, the reference's
parameters carried across with ``convert.lm_params_from_arrays``;
tolerances as ``tests/test_torch_lm.py``'s: 1e-4 (rtol and atol) in
float32, every element within 5e-2 of the largest magnitude in bfloat16.
K5's plain version at hubert's head dim, 80, is held to the Pallas kernel
in interpret mode, causal and not, within the reference's tolerances (2e-4
in float32, 2e-2 in bfloat16), and at a ragged length against the
reference's jnp attention; a ``gpu`` test holds both CUDA kernels at D 80
to the plain version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.kernels.flash_attention import flash_attention_fwd as r_fwd
from repro.layers.attention import flash_attention as r_flash
from repro.models import Model as RModel
from repro.models.steps import make_prefill_step as r_make_prefill
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import lm_arrays_from_params, lm_params_from_arrays
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import Model
from repro_torch.models.lm import check_ported
from repro_torch.models.steps import make_prefill_step

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
K5_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
B, S, P = 2, 24, 8


def _close(got, want, dtype):
    got = np.asarray(got.float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        err = float(np.abs(got - want).max())
        assert err <= TOL[dtype] * float(np.abs(want).max()), err
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    cfg = dataclasses.replace(r_get_smoke(arch), dtype=dtype)
    rm = RModel(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    return rm, rparams, Model(tcfg), tparams


def _batch(cfg, seed: int, frontend: str) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if frontend == "frames":
        out["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
            np.float32)
    elif frontend == "patch_embeds":
        out["patch_embeds"] = rng.normal(0, 1, (B, P, cfg.d_model)).astype(
            np.float32)
    return out


def _both(batch: dict, dtype: str):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rb = {k: jnp.asarray(v) if v.dtype == np.int32 else jnp.asarray(v, jdt)
          for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) if v.dtype == np.int32
          else torch.from_numpy(v).to(tdt) for k, v in batch.items()}
    return rb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,frontend", [
    ("hubert-xlarge", "frames"), ("qwen2-vl-2b", "patch_embeds")])
def test_frontend_forward_matches(arch, frontend, dtype):
    """forward, logits and the prefill step on frames or patch embeddings
    (qwen2-vl's first P positions replaced)."""
    rm, rp, tm, tp = _models(arch, dtype)
    rb, tb = _both(_batch(rm.cfg, 0, frontend), dtype)
    rx, _ = rm.forward(rp, rb)
    tx, _ = tm.forward(tp, tb)
    _close(tx, rx, dtype)
    _close(tm.logits(tp, tx), rm.logits(rp, rx), dtype)
    _close(make_prefill_step(tm)(tp, tb), r_make_prefill(rm)(rp, rb), dtype)


def test_patch_embeds_change_only_what_they_reach():
    """Causal qwen2-vl: positions before P see only patch embeddings, so
    two token streams that differ only under the patches give the same
    hidden states everywhere; without patches they differ."""
    _, _, tm, tp = _models("qwen2-vl-2b", "float32")
    batch = _batch(tm.cfg, 1, "patch_embeds")
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, :P] = (other["tokens"][:, :P] + 1) % tm.cfg.vocab
    _, tb = _both(batch, "float32")
    _, to = _both(other, "float32")
    x1, _ = tm.forward(tp, tb)
    x2, _ = tm.forward(tp, to)
    assert torch.equal(x1, x2)
    y1, _ = tm.forward(tp, {"tokens": tb["tokens"]})
    y2, _ = tm.forward(tp, {"tokens": to["tokens"]})
    assert not torch.equal(y1, y2)
    with pytest.raises(ValueError, match="do not fit"):
        tm.forward(tp, {"tokens": tb["tokens"][:, :P - 1],
                        "patch_embeds": tb["patch_embeds"]})


def test_in_proj_init_and_carry():
    """hubert draws ``in_proj`` [d, d] by the reference's ``scaled`` rule
    (std 1/sqrt(d)); it is carried across both ways."""
    cfg = get_smoke("hubert-xlarge")
    params = Model(cfg).init(0, device="cpu")
    w = params["in_proj"]
    assert tuple(w.shape) == (cfg.d_model, cfg.d_model)
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    back = lm_arrays_from_params(cfg, params)
    assert np.array_equal(back["in_proj"], w.numpy())
    again = lm_params_from_arrays(cfg, back, device="cpu")
    assert torch.equal(again["in_proj"], w)
    assert "in_proj" not in Model(get_smoke("qwen2-vl-2b")).init(
        0, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_is_ported(arch):
    check_ported(get_config(arch))
    check_ported(get_smoke(arch))


def _qkv80(seed, b, s, h, kvh, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, (b, s, h, 80)), rng.normal(0, 1, (b, s, kvh, 80)),
            rng.normal(0, 1, (b, s, kvh, 80))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kvh", [(1, 256, 4, 4), (2, 128, 4, 2)])
def test_plain_k5_at_d80_matches_pallas(b, s, h, kvh, causal, dtype):
    """K5's plain version at D 80 (at each kernel's key tile) against the
    Pallas kernel in interpret mode at that block_k (whose blocks must
    divide the length)."""
    (jq, jk, jv), (q, k, v) = _qkv80(5, b, s, h, kvh, dtype)
    bk = min(FA.kernel_block_k(q.dtype, 80), s)
    want = r_fwd(jq, jk, jv, causal=causal, block_q=min(128, s), block_k=bk)
    before = FA.launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal, block_k=bk)
    assert FA.launches == before
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=K5_TOL[dtype], atol=K5_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_k5_at_d80_ragged_matches_jnp(causal):
    """A ragged length at D 80 (1,500 frames' worth cut to 300, against
    both kernels' key tiles) against the reference's jnp attention, which
    the Pallas kernel's divisibility rule keeps out of the comparison
    above; float32."""
    (jq, jk, jv), (q, k, v) = _qkv80(7, 1, 300, 4, 2, "float32")
    want = r_flash(jq, jk, jv, causal=causal, q_offset=0)
    for bk in (64, 128):
        got = FA.flash_attention_plain(q, k, v, causal=causal, block_k=bk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=K5_TOL["float32"],
                                   atol=K5_TOL["float32"])


def test_d80_is_a_supported_head_dim():
    assert 80 in FA.SUPPORTED_HEAD_DIMS
    assert FA.kernel_block_k(torch.bfloat16, 80) == 128
    assert FA.kernel_block_k(torch.float32, 80) == 64
    # hubert's q, k and v, [B, S, 16, 80] bf16: a 160-byte head stride
    q = torch.zeros(1, 64, 16, 80, dtype=torch.bfloat16)
    assert FA.tma_strides("q", q.shape, q.stride(), q.data_ptr(),
                          q.element_size()) == (64 * 16 * 80, 16 * 80, 80)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kvh", [(1, 1500, 16, 16), (2, 333, 4, 2)])
def test_d80_kernels_match_plain_on_card(b, s, h, kvh, causal, dtype):
    """Both CUDA kernels at D 80 (``Tiles<80>``' five 16-column panels and
    ``wgmma_rs<80>``; ``Layout<80>``), one launch a call, against the plain
    version at the kernel's key tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               .to(tdt).to(dev)
               for shape in ((b, s, h, 80), (b, s, kvh, 80), (b, s, kvh, 80)))
    before = FA.launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal)
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    block_k=FA.kernel_block_k(tdt, 80))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=K5_TOL[dtype], atol=K5_TOL[dtype])
