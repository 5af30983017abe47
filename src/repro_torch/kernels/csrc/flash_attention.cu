// GQA flash-attention forward, float32, SIMT (sm_90a): K5's f32 path.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention.py:62) for float32 inputs; bfloat16
// goes to the Hopper kernel in flash_attention_sm90.cu (wgmma, TMA). q is
// [B, Sq, H, D], k and v are [B, Skv, KVH, D], addressed through the strides
// the wrapper passes (the innermost stride is 1); query head h reads kv head
// h / (H / KVH). Per row: online softmax with the running (m, l) in f32 over
// key tiles, scores scaled in f32, an optional causal mask from a common
// origin (row i sees keys j <= i), f32 products and accumulation, and
// o / max(l, 1e-30): the Pallas kernel's arithmetic, tile by tile, with
// another tile size.
//
// What bounds it: operations, 4*B*H*D flops for each (row, key) pair kept.
// The products are SIMT float32 FMAs (67 TFLOP/s peak), not tensor cores:
// TF32 would keep about three decimal digits, and the float32 path is held
// to the reference's 2e-4. Each thread block holds 64 rows of q and walks
// 64-key tiles of k and v through shared memory, so a key tile read from
// memory serves 64 rows and both products run from shared memory with
// 16-byte loads; each thread keeps a 4 x 8 tile of scores and a 4 x D/8
// tile of the output in registers. Causal tiles past a block's last row are
// never visited (the Pallas kernel walks them all): the first key tile is
// never fully masked for any row, so a skipped tile would only add
// exp(-1e30 - m) = 0. Blocks start with the longest rows, so the causal
// triangle's heavy blocks do not trail at the end.

#include <cuda_runtime.h>

#include "flash_params.cuh"

namespace {

constexpr int kBQ = 64;       // q rows a block
constexpr int kBK = 64;       // keys a tile
constexpr int kPad = 4;       // row padding of the transposed p tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "q and k tiles share load_transposed");

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
template <int D>
__device__ __forceinline__ void load_transposed(
    float* dst, const float* src, int64_t row_stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx % kBK, d = idx / kBK;
    const int row = row0 + r;
    dst[d * kBK + r] = row < n ? src[row * row_stride + d] : 0.f;
  }
}

template <int D>
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

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb
                    + hh * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb
                    + kh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb
                    + kh * p.v_sh;

  load_transposed<D>(qt, qp, p.q_ss, q0, p.sq);

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
    load_transposed<D>(kt, kp, p.k_ss, k0, p.skv);
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      vs[idx] = k0 + j < p.skv ? vp[(k0 + j) * p.v_ss + d] : 0.f;
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
        pr[i][c] = e;
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

  float* op = static_cast<float*>(p.o) + b * p.o_sb + hh * p.o_sh;
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
        op[row * p.o_ss + col] = acc[i][q2 * L::kVW + e] / den;
      }
  }
}

template <int D>
int launch(const FlashParams* p, cudaStream_t st) {
  const int bytes = Layout<D>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p->sq + kBQ - 1) / kBQ, p->b * p->h);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const FlashParams* p, cudaStream_t st) {
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

}  // namespace

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted.
int flash_attention_fwd(const FlashParams* p, void* stream) {
  if (p->sq <= 0 || p->b <= 0 || p->h <= 0) return 0;
  if (p->kvh <= 0 || p->h % p->kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // bfloat16 is flash_attention_sm90.cu's
  if (p->dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(p, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int flash_attention_params_size() {
  return static_cast<int>(sizeof(FlashParams));
}

}  // extern "C"
