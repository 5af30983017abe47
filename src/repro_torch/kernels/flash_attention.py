"""K5: GQA flash-attention forward, plain PyTorch version and CUDA kernel
wrapper (the port of ``repro.kernels.flash_attention``).

q is ``[B, Sq, H, D]``, k and v are ``[B, Skv, KVH, D]``; query head ``h``
attends with kv head ``h // (H // KVH)``. Per row, an online softmax over
key blocks keeps the running max ``m`` and denominator ``l`` in float32;
scores are scaled in float32, masked causally from a common origin (row
``i`` sees keys ``j <= i``) when ``causal``, ``p`` is rounded to v's dtype
before ``p @ v``, the sum is float32, and the output is
``o / max(l, 1e-30)`` in q's dtype.

``flash_attention_plain`` is that function as blocked PyTorch ops over
``block_k``-wide key blocks, every row at once (rows are independent, so
``block_q`` does not change the arithmetic; a causal block updates only the
rows that see one of its keys); a ragged last block is simply shorter.

``flash_attention_fwd`` dispatches on the tensors' device: the plain
version for CPU tensors; for CUDA tensors with D in
``SUPPORTED_HEAD_DIMS`` a kernel chosen by dtype, float32 to the SIMT
kernel (``csrc/flash_attention.cu``) and bfloat16 to the Hopper kernel
(``csrc/flash_attention_sm90.cu``: wgmma on the tensor cores, k and v
tiles by TMA); it raises for any other CUDA tensor: there is no fallback
between them. ``kernel_block_k`` is each kernel's key tile, where its
softmax rescales. ``launches`` counts kernel launches.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) the wrapper is the
custom op ``repro_torch::flash_attention_fwd``: a shape function, whose
FLOP formula (``tile_flops``) ``torch.utils.flop_counter.FlopCounterMode``
counts: the work of every tile the kernel of the dtype computes, the
causal tiles past a query block's last visible key skipped as the kernels
skip them.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from ._build import check_launch, check_params_size, load_library

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 96, 128)
# each kernel's key tile: the plain version with ``block_k`` at the kernel's
# tile rescales at the same keys, so p is rounded against the same running max
_BLOCK_K = {torch.float32: 64, torch.bfloat16: 128}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel of each dtype: its library, also the prefix of its C functions
KERNELS = {torch.float32: "flash_attention",
           torch.bfloat16: "flash_attention_sm90"}
# the largest byte stride a TMA tensor map takes
_TMA_MAX_STRIDE = 1 << 40

# each kernel's (query rows a block, keys a tile): csrc/flash_attention.cu's
# kBQ and kBK, csrc/flash_attention_sm90.cu's kBM and kBN
KERNEL_TILES = {torch.float32: (64, 64), torch.bfloat16: (128, 128)}

# kernel launches of ``flash_attention_fwd`` on CUDA tensors (plain integer;
# set to 0 before a run and read after it to see which path ran)
launches = 0


def kernel_block_k(dtype: torch.dtype, d: int) -> int:
    """The key tile of the kernel that serves ``dtype`` at head dim ``d``:
    64 for the float32 SIMT kernel, 128 for the bfloat16 Hopper kernel, at
    every D of ``SUPPORTED_HEAD_DIMS``."""
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash-attention kernels take head dims "
                         f"{SUPPORTED_HEAD_DIMS}, not {d}")
    if dtype not in _BLOCK_K:
        raise TypeError(f"the flash-attention kernels take float32 or "
                        f"bfloat16, not {dtype}")
    return _BLOCK_K[dtype]


def tma_strides(name: str, shape, strides, data_ptr: int,
                element_size: int) -> tuple[int, int, int]:
    """The (batch, sequence, head) strides, in elements, of a ``[B, S, H, D]``
    operand as the Hopper kernel's TMA tensor map takes them; raises
    ValueError for a layout TMA cannot address. A function of the shape,
    strides and address alone, so it is tested on CPU tensors. TMA needs a
    dense head dim, a 16-byte aligned address and byte strides that are
    multiples of 16 below 2^40; the stride of a dim of extent 1 is never
    used and is given the packed value."""
    b, s, h, d = shape
    sb, ss, sh, sd = strides
    if sd != 1:
        raise ValueError(f"{name}'s head dim must be dense (stride 1) for "
                         f"TMA")
    if data_ptr % 16:
        raise ValueError(f"{name} starts at an address that is not 16-byte "
                         f"aligned, which TMA cannot load")
    sh = sh if h > 1 else d
    ss = ss if s > 1 else h * sh
    sb = sb if b > 1 else s * ss
    for axis, st in (("head", sh), ("sequence", ss), ("batch", sb)):
        nbytes = st * element_size
        if nbytes <= 0 or nbytes % 16 or nbytes >= _TMA_MAX_STRIDE:
            raise ValueError(
                f"{name}'s {axis} stride is {nbytes} bytes; TMA takes "
                f"positive multiples of 16 below 2^40")
    return sb, ss, sh


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B,Sq,H,D] and k, v one [B,Skv,KVH,D] "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q, k and v must share batch and head dim")
    if k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          block_q: int = 256, block_k: int = 256
                          ) -> torch.Tensor:
    """The Pallas kernel's function in plain PyTorch ops (see the module
    docstring); the CPU path of ``flash_attention_fwd`` and the reference
    the kernels are held against on the card. ``block_k`` sets where the
    softmax rescales; ``block_q`` is checked and has no effect, since every
    row is computed at once and rows are independent."""
    _check_shapes(q, k, v)
    if block_q < 1 or block_k < 1:
        raise ValueError("blocks must be positive")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    bk = min(block_k, max(skv, 1))
    # [B, KVH, G, Sq, D] against [B, KVH, Skv, D]: no repeated k or v
    qg = q.float().reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, skv, bk):
        # causal: the rows before k0 see none of this block's keys, an
        # exact no-op of the online softmax (each row's max already holds
        # key 0's score), so only rows r0.. take the block
        r0 = min(k0, sq) if causal else 0
        if r0 == sq:
            break
        kb = kf[:, :, k0:k0 + bk]
        s = torch.matmul(qg[..., r0:, :],
                         kb[:, :, None].transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = torch.where(qpos[r0:] >= kpos[None, :], s, NEG_INF)
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l[..., r0:] = l[..., r0:] * corr + p.sum(dim=-1)
        m[..., r0:] = m_new
        pv = torch.matmul(p.to(v.dtype).float(),
                          vt[:, :, None, k0:k0 + bk].float())
        acc[..., r0:, :] = acc[..., r0:, :] * corr[..., None] + pv
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


class _FlashParams(ctypes.Structure):
    """Mirror of ``FlashParams`` in ``csrc/flash_params.cuh``."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("q", "k", "v", "o")]
                + [(f"{t}_s{a}", ctypes.c_int64)
                   for t in ("q", "k", "v", "o") for a in ("b", "s", "h")]
                + [(name, ctypes.c_int32) for name in (
                    "b", "sq", "skv", "h", "kvh", "d", "causal", "dtype")]
                + [("scale", ctypes.c_float)])


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """One kernel launch on the current stream (no sync; the output is the
    only allocation): the SIMT kernel for float32, the Hopper kernel for
    bfloat16."""
    global launches
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    b, sq, h, d = q.shape
    kernel_block_k(q.dtype, d)              # raises for dtype and head dim
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    tensors = {"q": q, "k": k, "v": v, "o": out}
    if q.dtype == torch.bfloat16:
        strides = {name: tma_strides(name, t.shape, t.stride(), t.data_ptr(),
                                     t.element_size())
                   for name, t in tensors.items()}
    else:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name}'s head dim must be dense "
                                 f"(stride 1)")
        if b * h > 65535:
            raise ValueError("B*H must be at most 65535")
        strides = {name: t.stride()[:3] for name, t in tensors.items()}
    if max(sq, k.shape[1]) >= (1 << 31):
        raise ValueError("sequences must be below 2^31")
    if q.numel() == 0:          # nothing to launch, nothing counted
        return out
    if k.shape[1] == 0:         # no keys: o = 0 / max(0, 1e-30)
        return out.zero_()
    lib_name = KERNELS[q.dtype]
    lib = load_library(lib_name)
    check_params_size(lib, f"{lib_name}_params_size", _FlashParams)
    p = _FlashParams()
    p.q, p.k, p.v, p.o = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr())
    for name in ("q", "k", "v", "o"):
        for axis, st in zip(("b", "s", "h"), strides[name]):
            setattr(p, f"{name}_s{axis}", st)
    p.b, p.sq, p.skv, p.h, p.kvh, p.d = b, sq, k.shape[1], h, k.shape[2], d
    p.causal = int(causal)
    p.dtype = _DTYPE_CODES[q.dtype]
    p.scale = scale
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, f"{lib_name}_fwd")(ctypes.addressof(p), stream)
    check_launch(lib, f"{lib_name}_error_string", err, lib_name)
    launches += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None,
                        block_q: int = 256, block_k: int = 256
                        ) -> torch.Tensor:
    """K5: ``[B,Sq,H,D]`` attention output (forward only). CPU tensors take
    the plain version with these blocks; CUDA tensors launch the kernel of
    their dtype, whose tiles are its own (the block arguments do not reach
    it; ``kernel_block_k`` gives its key tile), or raise. An empty q or k
    launches nothing: the output is empty, or zeros."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, float(scale))
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
                                                         float(scale))
    raise ValueError(f"unsupported device {q.device}")


def tile_flops(b: int, sq: int, skv: int, h: int, d: int, causal: bool,
               dtype: torch.dtype) -> int:
    """The FLOPs of the kernel of ``dtype`` on ``[b, sq, h, d]`` queries
    against ``skv`` keys: ``4 * BM * BN * d`` (the score tile and its
    product with v) for every (query block, key tile) it computes. A causal
    block stops at the tile holding its last visible key, as the kernels
    do."""
    bm, bn = KERNEL_TILES[dtype]
    tiles = 0
    for q0 in range(0, sq, bm):
        last_row = min(q0 + bm, sq) - 1
        last_key = min(last_row, skv - 1) if causal else skv - 1
        tiles += last_key // bn + 1 if last_key >= 0 else 0
    return 4 * bm * bn * d * tiles * b * h


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _k5_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           scale: float) -> torch.Tensor:
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)


@_k5_op.register_fake
def _k5_shape(q, k, v, causal, scale):
    _check_shapes(q, k, v)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _k5_flops(q, k, v, causal, scale, *, out_val=None) -> int:
    b, sq, h, d = q.shape
    return tile_flops(b, sq, k.shape[1], h, d, causal, q.dtype)


register_flop_formula(torch.ops.repro_torch.flash_attention_fwd,
                      get_raw=True)(_k5_flops)
