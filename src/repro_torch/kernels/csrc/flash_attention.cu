// GQA flash-attention forward for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention.py:62). q is [B, Sq, H, D], k and v are
// [B, Skv, KVH, D], f32 or bf16, addressed through the strides the wrapper
// passes (the innermost stride is 1); query head h reads kv head
// h / (H / KVH). Per row: online softmax with the running (m, l) in f32 over
// key tiles, scores scaled in f32, an optional causal mask from a common
// origin (row i sees keys j <= i), p rounded to the input type before p.v,
// f32 accumulation, and o / max(l, 1e-30) written in q's type: the Pallas
// kernel's arithmetic, tile by tile, with another tile size.
//
// What bounds it: operations. A causal launch does 4*B*H*D flops for each
// (row, key) pair it keeps, two products of 2*D each: at B = 1, H = 24,
// D = 128, Sq = Skv = 32768 that is 6.6 TFLOP against 0.54 GB of q, k, v and
// o, about 12,000 flops a byte, far above the H100's 295 flops a byte for
// bf16 tensor cores (989 TFLOP/s dense, 3.35 TB/s). This first kernel does
// the products as SIMT float32 FMAs (67 TFLOP/s peak), not on the tensor
// cores: each thread block holds 64 rows of q and walks 64-key tiles of k
// and v through shared memory, converted to f32 on load, so a key tile read
// from memory serves 64 rows and both products run from shared memory with
// 16-byte loads; each thread keeps a 4 x 8 tile of scores and a 4 x D/8
// tile of the output in registers. Causal tiles past a block's last row are
// never visited (the Pallas kernel walks them all): the first key tile is
// never fully masked for any row, so a skipped tile would only add
// exp(-1e30 - m) = 0. Blocks start with the longest rows, so the causal
// triangle's heavy blocks do not trail at the end. wgmma and TMA are the
// next step (ROADMAP queue 2).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct FlashParams {
  // field order mirrors _FlashParams in flash_attention.py
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements over (batch, sequence, head); the last dim is dense
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t b, sq, skv, h, kvh, d;
  int32_t causal;
  int32_t dtype;  // 0: float32, 1: bfloat16
  float scale;
};

namespace {

constexpr int kBQ = 64;       // q rows a block
constexpr int kBK = 64;       // keys a tile
constexpr int kPad = 4;       // row padding of the transposed p tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "q and k tiles share load_transposed");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// p as the Pallas kernel feeds it to p.v: p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_p(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D> struct Layout {
  static constexpr int kVW = (D % 32 == 0) ? 4 : 2;  // output cols a load
  static constexpr int kNQ = D / (8 * kVW);           // loads a key row
  static constexpr int kCols = D / 8;                 // output cols a thread
  static constexpr int kKP = (D * kBK > kBK * (kBQ + kPad))
                                 ? D * kBK : kBK * (kBQ + kPad);
  static constexpr int kFloats = D * kBQ + kKP + kBK * D;
  static_assert(D % 16 == 0 && kNQ * 8 * kVW == D, "unsupported head dim");
};

template <int VW> struct Vec;
template <> struct Vec<2> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
};
template <> struct Vec<4> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// rows [row0, row0 + 64) of one head as a [D][64] f32 tile: lanes run along
// the rows, so the transposed stores hit 32 banks; rows past n are zeros
template <typename T, int D>
__device__ __forceinline__ void load_transposed(
    float* dst, const T* src, int64_t row_stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx % kBK, d = idx / kBK;
    const int row = row0 + r;
    dst[d * kBK + r] = row < n ? to_f32(src[row * row_stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const FlashParams p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][kBQ]
  float* kt = qt + D * kBQ;         // [D][kBK], then p as [kBK][kBQ + kPad]
  float* pt = kt;
  float* vs = kt + L::kKP;          // [kBK][D]

  const int tid = threadIdx.x;
  const int tc = tid & 7;           // column group (8 lanes share a row)
  const int tr = tid >> 3;          // row group: rows tr*4 .. tr*4 + 3
  const int bh = blockIdx.y;
  const int b = bh / p.h, hh = bh % p.h;
  const int kh = hh / (p.h / p.kvh);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_transposed<T, D>(qt, qp, p.q_ss, q0, p.sq);

  float m[4], l[4], acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: stop at the tile holding the block's last visible key
  const int last_row = min(q0 + kBQ, p.sq) - 1;
  const int last_key = p.causal ? min(last_row, p.skv - 1) : p.skv - 1;
  const int n_tiles = last_key < 0 ? 0 : last_key / kBK + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    load_transposed<T, D>(kt, kp, p.k_ss, k0, p.skv);
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      vs[idx] = k0 + j < p.skv ? to_f32(vp[(k0 + j) * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // s = q k^T: rows tr*4 + i, keys 4*tc + e and 32 + 4*tc + e
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
      Vec<4>::load(qt + d * kBQ + tr * 4, qv);
      Vec<4>::load(kt + d * kBK + 4 * tc, kv);
      Vec<4>::load(kt + d * kBK + 32 + 4 * tc, kv + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = __fmaf_rn(qv[i], kv[c], s[i][c]);
    }

    // scale, mask, and the online-softmax update of each row
    float pr[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int key = k0 + (c < 4 ? 4 * tc + c : 32 + 4 * tc + c - 4);
        const bool keep = key < p.skv && (!p.causal || row >= key);
        s[i][c] = keep ? s[i][c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float e = expf(s[i][c] - m_new);
        sum += e;
        pr[i][c] = round_p<T>(e);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();              // every thread is done reading the k tile

#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = c < 4 ? 4 * tc + c : 32 + 4 * tc + c - 4;
      *reinterpret_cast<float4*>(pt + j * (kBQ + kPad) + tr * 4) =
          make_float4(pr[0][c], pr[1][c], pr[2][c], pr[3][c]);
    }
    __syncthreads();

    // o += p v: output cols q2*8*VW + tc*VW + e
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
      Vec<4>::load(pt + j * (kBQ + kPad) + tr * 4, pv);
#pragma unroll
      for (int q2 = 0; q2 < L::kNQ; ++q2) {
        float vv[L::kVW];
        Vec<L::kVW>::load(vs + j * D + q2 * 8 * L::kVW + tc * L::kVW, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < L::kVW; ++e)
            acc[i][q2 * L::kVW + e] =
                __fmaf_rn(pv[i], vv[e], acc[i][q2 * L::kVW + e]);
      }
    }
    __syncthreads();              // before the next tile overwrites k, p, v
  }

  T* op = static_cast<T*>(p.o) + b * p.o_sb + hh * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int q2 = 0; q2 < L::kNQ; ++q2)
#pragma unroll
      for (int e = 0; e < L::kVW; ++e) {
        const int col = q2 * 8 * L::kVW + tc * L::kVW + e;
        op[row * p.o_ss + col] = from_f32<T>(acc[i][q2 * L::kVW + e] / den);
      }
  }
}

template <typename T, int D>
int launch(const FlashParams* p, cudaStream_t st) {
  const int bytes = Layout<D>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p->sq + kBQ - 1) / kBQ, p->b * p->h);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const FlashParams* p, cudaStream_t st) {
  switch (p->d) {
    case 16: return launch<T, 16>(p, st);
    case 32: return launch<T, 32>(p, st);
    case 64: return launch<T, 64>(p, st);
    case 96: return launch<T, 96>(p, st);
    case 128: return launch<T, 128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted.
int flash_attention_fwd(const FlashParams* p, void* stream) {
  if (p->sq <= 0 || p->b <= 0 || p->h <= 0) return 0;
  if (p->kvh <= 0 || p->h % p->kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch_d<float>(p, st);
  if (p->dtype == 1) return launch_d<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int flash_attention_params_size() {
  return static_cast<int>(sizeof(FlashParams));
}

}  // extern "C"
