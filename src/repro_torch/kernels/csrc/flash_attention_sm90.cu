// GQA flash-attention forward for Hopper, bfloat16 (sm_90a): K5's bf16 path.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention.py:62) for bfloat16 inputs; float32
// stays on the SIMT kernel in flash_attention.cu. q is [B, Sq, H, D], k and
// v are [B, Skv, KVH, D]; query head h reads kv head h / (H / KVH). The
// arithmetic is the Pallas kernel's, at 128-key tiles: scores in f32 from
// bf16 products, scaled, masked causally from a common origin (row i sees
// keys j <= i), the online softmax's running (m, l) in f32, p rounded to
// bf16 before p.v, the sum in f32, and o / max(l, 1e-30) stored in bf16.
//
// What bounds it: operations. A causal launch at B 1, H 24, D 128 and
// Sq = Skv = 32768 does 6.6 TFLOP against 0.54 GB of q, k, v and o, far
// above the H100's 295 flops a byte for bf16 tensor cores (989 TFLOP/s
// dense, 3.35 TB/s). So both products run on the tensor cores:
//
// * A block covers 128 query rows of one (batch, head): warpgroup 0 is the
//   producer (one thread issues every TMA load, the group keeps 24
//   registers a thread), warpgroups 1 and 2 are consumers of 64 rows each
//   (240 registers a thread, setmaxnreg).
// * TMA brings q once and 128-key tiles of k and v through a ring of two
//   shared-memory stages, each tile arriving on its own mbarrier; the
//   consumers' eight warps release a stage after their p.v. The tensor maps
//   are 4-D over [B, S, H, D] with the caller's strides, so nothing is
//   transposed or copied on the host; rows past Sq or Skv arrive as zeros.
// * Tiles are panels of PW columns, PW*2 bytes a row, in the matching
//   swizzle: 128 bytes for D 64 and 128, 64 bytes for D 32 and 96, 32 bytes
//   for D 16 and 80 (hubert's heads: five 16-column panels). A TMA box's
//   inner extent is its swizzle span, and the wgmma descriptors carry the
//   same swizzle mode; the v descriptor steps from panel to panel by its
//   leading byte offset, so q.k^T takes one panel a k-step and p.v one
//   m64nDk16 over all of them.
// * S = q.k^T is wgmma with both operands in shared memory, K-major; S sits
//   in registers (64 x 128 f32 a warpgroup). p is rounded to bf16 in
//   registers and fed back as wgmma's A operand (the accumulator layout is
//   the A-fragment layout); v is the B operand in its stored [key][D]
//   layout through wgmma's transpose-B mode.
// * Causal: tiles past a block's last row are never visited, only tiles
//   that reach past a warpgroup's first row (or past Skv) are masked, and
//   blocks start with the longest rows. The H / KVH query heads of one kv
//   head are neighbours in the grid, so their k and v tiles come from L2.
//
// Not here yet (ROADMAP queue 2): overlap of one tile's softmax with the
// next tile's product inside a warpgroup, ping-pong between the two
// warpgroups, and a persistent grid.
//
// The shared build flags carry --fmad=false (K1-K4 interpolate bit for bit),
// so no multiply and add here fuse unless written as __fmaf_rn. The softmax
// takes exp2f((x - m) * log2(e)) where the plain version takes exp(x - m):
// x - m is exact where it matters (x near m), and the product and ex2.approx
// add about 2^-22 relative error to p, far inside bf16's 2^-9 rounding of p.

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_params.cuh"

namespace {

constexpr int kBM = 128;             // q rows a block: two warpgroups of 64
constexpr int kBN = 128;             // keys a tile
constexpr int kStages = 2;           // k/v tiles in flight
constexpr int kThreads = 384;        // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory layout of one head dim
template <int D> struct Tiles {
  static constexpr int kPW = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int kPanels = D / kPW;
  static constexpr int kSwizzleBytes = kPW * 2;         // one panel row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;          // one k or v tile
  static constexpr int kQPanel = kBM * kPW * 2;
  static constexpr int kKVPanel = kBN * kPW * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBars = 1 + 3 * kStages;         // q, k/v full, empty
  // + 1024: the base is rounded up to the 1024-byte swizzle repeat
  static constexpr int kSmemBytes = kBarOffset + 8 * kBars + 1024;
  static_assert(D % 16 == 0 && kPanels * kPW == D, "unsupported head dim");
  static_assert(kQPanel % 1024 == 0 && kKVPanel % 1024 == 0,
                "panels must keep the swizzle repeat aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of this parity has completed; every wait
// of the pipeline ends within a tile's time, so one that lasts 2^34 cycles
// (about 10 s) is a fault: trap rather than hold the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

// one box of a 4-D map at coordinates (d, head, row, batch), innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a panel whose rows are PW*2 bytes in
// that swizzle: start address, leading byte offset (K-major: unused, 1;
// MN-major: the stride between PW-column panels), stride byte offset (8 rows
// of PW*2 bytes), swizzle mode (1: 128 B, 2: 64 B, 3: 32 B). Offsets of
// whole 16 bytes inside a panel add to the start address.
template <int PW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr,
                                              uint32_t lbo_bytes) {
  constexpr uint64_t mode = PW == 64 ? 1 : (PW == 32 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>(PW) << 32
         | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F8(i) F4(i), F4(i + 4)
#define F16(i) F8(i), F8(i + 8)

// d (+)= A.B^T, m64 x nN x k16, A and B K-major in shared memory;
// scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, uint32_t scale_d);
// d += A.B, m64 x nN x k16, A the bf16 fragments in registers, B MN-major
// in shared memory (transpose-B)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <> __device__ __forceinline__ void wgmma_ss<128>(
    float (&d)[64], uint64_t a, uint64_t b, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<80>(
    float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16), F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<96>(
    float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16), F16(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F16
#undef F8
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the kernel -----------------------------------------------------------

// Accumulator layout of m64nN (f32): thread t of a warpgroup holds, for each
// 8-column group j, d[4j + 2i + e] = (row 16*(t/32) + t%32/4 + 8i,
// column 8j + 2*(t%4) + e), i, e in {0, 1}.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    float scale, int k0, int row0, int col0, int skv, bool causal) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    const int i = (j >> 1) & 1;
    float x = s[j] * scale;
    if (kMask) {
      const int key = k0 + 8 * (j >> 2) + col0 + (j & 1);
      if (key >= skv || (causal && key > row0 + 8 * i)) x = kNegInf;
    }
    s[j] = x;
    mx[i] = fmaxf(mx[i], x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the four threads of a row hold its 128 keys between them
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2f((m[i] - mx[i]) * kLog2e);
    m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    const int i = (j >> 1) & 1;
    s[j] = exp2f((s[j] - m[i]) * kLog2e);
    sum[i] += s[j];
  }
  // this thread's share of l; the four shares are summed at the end
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const FlashParams p) {
  using T = Tiles<D>;
  constexpr int PW = T::kPW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;
  uint8_t* sk = base + T::kQBytes;                       // [stage] tiles
  uint8_t* sv = sk + kStages * T::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  // block -> (q block, batch, head): q blocks outermost, longest rows
  // first; heads innermost, so one kv head's query heads are neighbours
  const int bh = p.b * p.h;
  const int n_qb = (p.sq + kBM - 1) / kBM;
  const int q0 = (n_qb - 1 - static_cast<int>(blockIdx.x) / bh) * kBM;
  const int b = static_cast<int>(blockIdx.x) % bh / p.h;
  const int hh = static_cast<int>(blockIdx.x) % p.h;
  const int kh = hh / (p.h / p.kvh);
  // causal: stop at the tile holding the block's last visible key
  const int last_row = min(q0 + kBM, p.sq) - 1;
  const int last_key = p.causal ? min(last_row, p.skv - 1) : p.skv - 1;
  const int n_tiles = last_key / kBN + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kPanels; ++c)
        tma_load(sq + c * T::kQPanel, &tq, q_full, c * PW, hh, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + s, ((t / kStages) - 1) & 1);
        mbar_expect_tx(k_full + s, T::kKVBytes);
        for (int c = 0; c < T::kPanels; ++c)
          tma_load(sk + s * T::kKVBytes + c * T::kKVPanel, &tk, k_full + s,
                   c * PW, kh, t * kBN, b);
        mbar_expect_tx(v_full + s, T::kKVBytes);
        for (int c = 0; c < T::kPanels; ++c)
          tma_load(sv + s * T::kKVBytes + c * T::kKVPanel, &tv, v_full + s,
                   c * PW, kh, t * kBN, b);
      }
    }
  } else {
    // ---- consumers: 64 rows a warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31;
    const int wrow = q0 + cw * 64;                 // the warpgroup's first row
    const int row0 = wrow + (tid >> 5) * 16 + (lane >> 2);   // and row0 + 8
    const int col0 = 2 * (lane & 3);

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // descriptors at the first panel of q (this warpgroup's rows), k and v
    const uint64_t q_desc =
        smem_desc<PW>(smem_u32(sq) + cw * 64 * PW * 2, 16);
    const uint64_t k_desc = smem_desc<PW>(smem_u32(sk), 16);
    const uint64_t v_desc = smem_desc<PW>(smem_u32(sv), T::kKVPanel);

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = t * kBN;
      const uint64_t stage_off = (s * T::kKVBytes) >> 4;

      // S = q.k^T over D in steps of 16: panel c, 32-byte step inside it
      float sc[kBN / 2];
      mbar_wait(k_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16 / PW, in = (ks * 16 % PW) * 2;
        wgmma_ss<kBN>(sc, q_desc + ((c * T::kQPanel + in) >> 4),
                      k_desc + stage_off + ((c * T::kKVPanel + in) >> 4),
                      ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      float corr[2];
      const bool mask =
          (p.causal && k0 + kBN - 1 > wrow) || k0 + kBN > p.skv;
      if (mask)
        softmax_tile<true>(sc, m, l, corr, p.scale, k0, row0, col0, p.skv,
                           p.causal);
      else
        softmax_tile<false>(sc, m, l, corr, p.scale, k0, row0, col0, p.skv,
                            p.causal);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];
      // p as bf16 A fragments: 16 keys a step, the accumulator's 8 values
      // of two column groups in order
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // o += p.v over the tile's keys in steps of 16 (16 rows of v)
      fence_regs(o);
      mbar_wait(v_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    v_desc + stage_off + ((kk * 16 * PW * 2) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb
                        + hh * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.sq) continue;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
        *reinterpret_cast<__nv_bfloat162*>(
            op + static_cast<int64_t>(row) * p.o_ss + 8 * j + col0) = v;
      }
    }
  }
}

// ---- host -----------------------------------------------------------------

// encode failures come back as kEncodeError + the CUresult, apart from
// cudaError_t's range
constexpr int kEncodeError = 100000;

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  // the driver's entry point through the runtime: no -lcuda
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// a 4-D map over [B, S, H, D] (innermost D first) whose box is one panel of
// `rows` rows of one head; rows past `s` read as zeros
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
             int64_t sb, int64_t ss, int64_t sh, int rows) {
  using T = Tiles<D>;
  auto encode = encode_fn();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kPW), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSwizzleBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kSwizzleBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int D>
int launch(const FlashParams* p, cudaStream_t st) {
  using T = Tiles<D>;
  alignas(64) CUtensorMap tq, tk, tv;
  int err = make_map<D>(&tq, p->q, p->b, p->sq, p->h, p->q_sb, p->q_ss,
                        p->q_sh, kBM);
  if (err == 0)
    err = make_map<D>(&tk, p->k, p->b, p->skv, p->kvh, p->k_sb, p->k_ss,
                      p->k_sh, kBN);
  if (err == 0)
    err = make_map<D>(&tv, p->v, p->b, p->skv, p->kvh, p->v_sb, p->v_ss,
                      p->v_sh, kBN);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks =
      static_cast<int64_t>((p->sq + kBM - 1) / kBM) * p->b * p->h;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_sm90<D><<<static_cast<unsigned>(blocks), kThreads, T::kSmemBytes,
                      st>>>(tq, tk, tv, *p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns 0 when the launch was accepted, a cudaError_t, or kEncodeError +
// a CUresult when a tensor map could not be encoded. The wrapper has
// checked what TMA needs: 16-byte aligned pointers and strides.
int flash_attention_sm90_fwd(const FlashParams* p, void* stream) {
  if (p->sq <= 0 || p->b <= 0 || p->h <= 0) return 0;
  if (p->kvh <= 0 || p->h % p->kvh != 0 || p->skv <= 0 || p->dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->d) {
    case 16: return launch<16>(p, st);
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
    case 80: return launch<80>(p, st);
    case 96: return launch<96>(p, st);
    case 128: return launch<128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_sm90_error_string(int err) {
  if (err >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (TMA): see the "
           "CUresult in the error code minus 100000";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int flash_attention_sm90_params_size() {
  return static_cast<int>(sizeof(FlashParams));
}

}  // extern "C"
