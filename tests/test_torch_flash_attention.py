"""K5 and the attention core of the port against the reference.

The plain version of ``repro_torch.kernels.flash_attention`` is held against
the reference's Pallas ``flash_attention_fwd`` in interpret mode over
``test_pallas_flash_sweep``'s shapes and dtypes, and against the jnp
``flash_attention`` on a ragged length; the port's ``layers.attention.
flash_attention`` against the jnp one under every mask it has. Tolerances
are the reference's own: 2e-4 in float32 and 2e-2 in bfloat16 (rtol and
atol), the block orders of the two sides differing. ``gpu`` tests hold the
CUDA kernel against the plain version on a card and check what it refuses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as r_fwd
from repro.layers.attention import flash_attention as r_flash
from repro_torch.kernels import flash_attention as FA
from repro_torch.layers.attention import flash_attention

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SWEEP = [(2, 256, 4, 2, 64, True), (1, 512, 8, 8, 32, True),
         (2, 256, 4, 1, 128, False), (1, 128, 2, 2, 16, True)]


def _qkv(rng, b, sq, skv, h, kvh, d, dtype, dv=None):
    """The same numpy normals as reference arrays and port tensors."""
    arrs = [rng.normal(0, 1, (b, sq, h, d)),
            rng.normal(0, 1, (b, skv, kvh, d)),
            rng.normal(0, 1, (b, skv, kvh, dv or d))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,d,causal", SWEEP)
def test_plain_matches_pallas_sweep(b, s, h, kvh, d, causal, dtype):
    rng = np.random.default_rng(0)
    (jq, jk, jv), (q, k, v) = _qkv(rng, b, s, s, h, kvh, d, dtype)
    want = r_fwd(jq, jk, jv, causal=causal, block_q=128, block_k=128)
    before = FA.launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal, block_q=128,
                                 block_k=128)
    assert FA.launches == before            # CPU tensors: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_matches_jnp(causal):
    """A length that no block divides (200 over 128-wide key blocks)."""
    rng = np.random.default_rng(1)
    (jq, jk, jv), (q, k, v) = _qkv(rng, 2, 200, 200, 6, 2, 32, "float32")
    want = r_flash(jq, jk, jv, causal=causal, q_offset=0)
    got = FA.flash_attention_plain(q, k, v, causal=causal, block_k=128)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("case", ["causal", "bidirectional", "window",
                                  "decode", "kv_len", "k_positions",
                                  "split_dv"])
def test_flash_attention_matches_jnp(case):
    rng = np.random.default_rng(2)
    sq, skv, dv = {"decode": (1, 64, None), "kv_len": (1, 64, None),
                   "k_positions": (1, 32, None),
                   "split_dv": (48, 48, 24)}.get(case, (48, 48, None))
    (jq, jk, jv), (q, k, v) = _qkv(rng, 2, sq, skv, 4, 2, 16, "float32",
                                   dv=dv)
    kw: dict = dict(causal=case != "bidirectional", q_offset=0, chunk=16)
    jkw: dict = {}
    tkw: dict = {}
    if case == "window":
        kw["window"] = 8
    elif case in ("decode", "kv_len"):
        kw["q_offset"] = 40
        if case == "kv_len":
            kw["causal"] = False
            kw["kv_len"] = 37
    elif case == "k_positions":
        # a ring buffer of 32 slots at position 45: slots hold 14..45, one
        # slot unwritten
        kpos = np.arange(14, 46) % 64
        kpos[5] = -10**9
        kpos = np.roll(kpos, 3).astype(np.int32)
        kw.update(q_offset=45, window=32)
        jkw["k_positions"] = jnp.asarray(kpos)
        tkw["k_positions"] = torch.from_numpy(kpos)
    want = r_flash(jq, jk, jv, **kw, **jkw)
    got = flash_attention(q, k, v, **kw, **tkw)
    _close(got, want, TOL["float32"])


def test_wrapper_checks_shapes():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="shape"):
        FA.flash_attention_fwd(q, k, torch.zeros(1, 8, 2, 32))


# ----------------------------------------------------------------- card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,d,causal", SWEEP + [
    (1, 200, 6, 2, 96, True), (2, 77, 4, 4, 128, False)])
def test_kernel_matches_plain_on_card(b, s, h, kvh, d, causal, dtype):
    """One launch per call, against the plain version at the kernel's key
    tile on the same device inputs (``python3 chip_smoke.py`` does the same
    at the prefill shape)."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    _, (q, k, v) = _qkv(rng, b, s, s, h, kvh, d, dtype)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    before = FA.launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal)
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    block_k=FA.KERNEL_BLOCK_K)
    _close(got.cpu(), want.cpu().float().numpy(), TOL[dtype])


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_serve():
    dev = _cuda()
    bad_d = torch.zeros(1, 8, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_fwd(bad_d, bad_d, bad_d)
    half = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or"):
        FA.flash_attention_fwd(half, half, half)


@pytest.mark.gpu
def test_kernel_counts_no_launch_for_empty_q():
    dev = _cuda()
    q = torch.zeros(1, 0, 4, 64, device=dev)
    k = torch.zeros(1, 8, 2, 64, device=dev)
    before = FA.launches
    out = FA.flash_attention_fwd(q, k, k)
    assert out.shape == q.shape and FA.launches == before
