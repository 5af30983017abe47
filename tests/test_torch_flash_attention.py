"""K5 and the attention core of the port against the reference.

The plain version of ``repro_torch.kernels.flash_attention`` is held against
the reference's Pallas ``flash_attention_fwd`` in interpret mode over
``test_pallas_flash_sweep``'s shapes and dtypes, and against the jnp
``flash_attention`` on a ragged length; the port's ``layers.attention.
flash_attention`` against the jnp one under every mask it has; and, at
each kernel's own key tile (``kernel_block_k``: 64 for the float32 SIMT
kernel, 128 for the bfloat16 Hopper kernel), against the Pallas kernel at
the same ``block_k`` for the head dims of phi3-mini (96) and minitron-4b
(128) at GQA group 3. Tolerances are the reference's own: 2e-4 in float32
and 2e-2 in bfloat16 (rtol and atol), the block orders of the two sides
differing. The TMA layout check is a function of shapes, strides and the
address, tested here on CPU tensors. ``gpu`` tests hold the CUDA kernels
against the plain version on a card and check what they refuse.
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_at_kernel_tile_matches_pallas(d, causal, dtype):
    """The replay the card's checks use: the plain version at the kernel's
    key tile against the Pallas kernel (interpret mode) at that block_k,
    GQA group 3 (6 query heads over 2 kv heads)."""
    rng = np.random.default_rng(4)
    (jq, jk, jv), (q, k, v) = _qkv(rng, 1, 256, 256, 6, 2, d, dtype)
    bk = FA.kernel_block_k(q.dtype, d)
    want = r_fwd(jq, jk, jv, causal=causal, block_q=128, block_k=bk)
    got = FA.flash_attention_plain(q, k, v, causal=causal, block_k=bk)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


def test_kernel_block_k_per_dtype():
    for d in FA.SUPPORTED_HEAD_DIMS:
        assert FA.kernel_block_k(torch.float32, d) == 64
        assert FA.kernel_block_k(torch.bfloat16, d) == 128
    with pytest.raises(TypeError, match="float32 or"):
        FA.kernel_block_k(torch.float16, 64)
    with pytest.raises(ValueError, match="head dims"):
        FA.kernel_block_k(torch.bfloat16, 48)


def _tma(name, t):
    return FA.tma_strides(name, t.shape, t.stride(), t.data_ptr(),
                          t.element_size())


def test_tma_strides_accept_the_main_path_layouts():
    bf = torch.bfloat16
    # the prefill's q, k and v: contiguous [B, S, H, D], minitron's heads
    q = torch.zeros(1, 64, 24, 128, dtype=bf)
    assert _tma("q", q) == (64 * 24 * 128, 24 * 128, 128)
    k = torch.zeros(2, 64, 8, 128, dtype=bf)
    assert _tma("k", k) == (64 * 8 * 128, 8 * 128, 128)
    # a [B, S, H, D] view of [B, H, S, D]: nothing is copied for TMA
    t = torch.zeros(2, 8, 64, 96, dtype=bf).transpose(1, 2)
    assert _tma("k", t) == (8 * 64 * 96, 96, 64 * 96)
    # the heads of a fused projection, sliced: their strides pass as given
    fused = torch.zeros(1, 64, 24 + 2 * 8, 16, dtype=bf)
    assert _tma("v", fused[:, :, 32:]) == (64 * 40 * 16, 40 * 16, 16)
    # a dim of extent 1 takes the packed stride, whatever torch reports
    one = torch.zeros(1, 1, 1, 32, dtype=bf).as_strided(
        (1, 1, 1, 32), (7, 5, 3, 1))
    assert _tma("q", one) == (32, 32, 32)


def test_tma_strides_refuse_what_tma_cannot_take():
    bf = torch.bfloat16
    narrow = torch.zeros(1, 8, 3, 20, dtype=bf)[..., :16]   # 40-byte heads
    with pytest.raises(ValueError, match="TMA"):
        _tma("k", narrow)
    flat = torch.zeros(1 + 8 * 2 * 16, dtype=bf)
    shifted = flat[1:].view(1, 8, 2, 16)                    # 2-byte offset
    with pytest.raises(ValueError, match="TMA"):
        _tma("q", shifted)
    strided = torch.zeros(1, 8, 2, 32, dtype=bf)[..., ::2]  # D not dense
    with pytest.raises(ValueError, match="TMA"):
        _tma("v", strided)


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
    (1, 200, 6, 2, 96, True), (2, 77, 4, 4, 128, False),
    (1, 1000, 6, 2, 96, True), (1, 4096, 24, 8, 128, True),
    (1, 4096, 24, 8, 128, False), (1, 1000, 4, 2, 16, False),
    (2, 333, 4, 1, 32, False)])
def test_kernel_matches_plain_on_card(b, s, h, kvh, d, causal, dtype):
    """One launch per call, against the plain version at the kernel's key
    tile on the same device inputs (``python3 chip_smoke.py`` does the same
    at the prefill shape): float32 runs the SIMT kernel, bfloat16 the
    Hopper kernel."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    _, (q, k, v) = _qkv(rng, b, s, s, h, kvh, d, dtype)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    before = FA.launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal)
    assert FA.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    block_k=FA.kernel_block_k(q.dtype, d))
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
def test_hopper_kernel_refuses_unaligned_views():
    dev = _cuda()
    narrow = torch.zeros(1, 8, 3, 20, device=dev,
                         dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="TMA"):
        FA.flash_attention_fwd(narrow, narrow, narrow)


@pytest.mark.gpu
def test_kernel_counts_no_launch_for_empty_q():
    dev = _cuda()
    q = torch.zeros(1, 0, 4, 64, device=dev)
    k = torch.zeros(1, 8, 2, 64, device=dev)
    before = FA.launches
    out = FA.flash_attention_fwd(q, k, k)
    assert out.shape == q.shape and FA.launches == before
    # no keys: zeros, as the plain version gives, and nothing launched
    q = torch.ones(1, 8, 4, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 0, 2, 64, device=dev, dtype=torch.bfloat16)
    out = FA.flash_attention_fwd(q, k, k)
    assert FA.launches == before and not out.float().abs().any()
