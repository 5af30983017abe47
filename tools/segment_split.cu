// Parts of K2/K3 (src/repro_torch/kernels/csrc/segment_lookup.cu) alone,
// and candidate designs left out of it, to split its time on the card. A
// measurement aid for tools/segment_split.py, not part of the port.
#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

struct SegParams {
  // the layout of SegParams in csrc/segment_lookup.cu (field order mirrors
  // _SegParams in segment_lookup.py)
  const int64_t* q;
  const int64_t* sk;
  const float* spos;
  const int32_t* table;
  const uint32_t* cells;
  int32_t* out;
  const int64_t* dk;
  const int64_t* s1;
  const int64_t* s2;
  int64_t n_q;
  int64_t min_key;
  int64_t n_row;
  int64_t n1;
  int32_t n_spline;
  int32_t eps_eff;
  int32_t base_max;
  int32_t shift;
  int32_t p_max;
  int32_t search_width;
  int32_t search_trips;
  int32_t r;
  int32_t levels;
  int32_t delta;
  int32_t window;
};

enum {
  kStream = 0,        // read the key, write 4 bytes: the 12 B a query
  kLayer = 1,         // the table pair or the CHT descent alone
  kLayerCount = 2,    // + the spline search, each form (writes the segment)
  kLayerBisect = 3,
  kLayerAdaptive = 4,
  kLayerSegment = 5,  // bisect to one 8-key segment, then 16-byte loads
  kLayerBisectX2 = 6, // fixed-trip bisect, two queries a thread interleaved
  kLayerWarp8 = 7,    // 8 lanes a query, the window cut 9 ways a step
  kWholePlain = 8,    // the whole kernel, adaptive form, no cache hints
  kLayerSmem = 9,     // CHT: the descent with level 0 staged in shared memory
  kFusedPlain = 10,   // the fused kernel (one summary level), adaptive form,
                      // its K2/K3 part without cache hints
};

// #{j in [lo, hi) : sk[j] <= q} for [lo, hi) inside the 8-key segment
// starting at `start`: a whole, 16-byte aligned segment as four 16-byte
// kept loads, a partial one key by key.
__device__ __forceinline__ int32_t count_le_in_segment(
    const KeptLoad& ld, const int64_t* sk, int32_t ns, int32_t start,
    int32_t lo, int32_t hi, int64_t q) {
  if (lo >= hi) return 0;
  int32_t c = 0;
  const int64_t* seg = sk + start;
  if (start + kSegment <= ns &&
      (reinterpret_cast<uintptr_t>(seg) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < kSegment / 2; ++k) {
      longlong2 w;
      asm("ld.global.nc.L2::cache_hint.v2.s64 {%0, %1}, [%2], %3;"
          : "=l"(w.x), "=l"(w.y) : "l"(seg + 2 * k), "l"(ld.pol));
      const int32_t j = start + 2 * k;
      c += (j >= lo && j < hi && w.x <= q);
      c += (j + 1 >= lo && j + 1 < hi && w.y <= q);
    }
  } else {
    for (int32_t j = lo; j < hi; ++j) c += (ld.key(sk + j) <= q);
  }
  return c;
}

// The segment form: the last 8-aligned key <= q in [lo, hi] by bisect (k0 -
// 1 when none is), then a count over the window's part of its 8-key
// segment (none found: the part before the first aligned key).
__device__ __forceinline__ int32_t segment_predecessor(
    const KeptLoad& ld, const int64_t* sk, int32_t ns, int64_t q, int32_t lo,
    int32_t hi) {
  hi = min(hi, ns - 1);
  if (hi < lo) return lo;
  const int32_t k0 = (lo + kSegment - 1) / kSegment;
  int32_t a = k0 - 1;
  int32_t b = hi / kSegment;
  while (a < b) {
    const int32_t mid = (a + b + 1) >> 1;
    if (ld.key(sk + mid * kSegment) <= q) a = mid;
    else b = mid - 1;
  }
  const bool found = a >= k0;
  const int32_t s = found ? a * kSegment : lo;
  const int32_t e = min(found ? s + kSegment : k0 * kSegment, hi + 1);
  return max(s + count_le_in_segment(ld, sk, ns, s - s % kSegment, s, e, q) -
                 1,
             lo);
}

template <int KIND, class L>
__device__ __forceinline__ void layer(const L& ld, const SegParams& p,
                                      int64_t q, int32_t& lo, int32_t& hi) {
  if (KIND == 0) {
    radix_window(ld, p.table, q, p.min_key, p.shift, p.p_max, lo, hi);
  } else {
    lo = cht_descend(ld, p.cells, q, p.r, p.levels);
    hi = min(lo + p.delta, p.n_spline - 1);
  }
}

template <int KIND, int V>
__global__ void __launch_bounds__(256) split_kernel(const SegParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const KeptLoad kept{summary_policy()};
  const PlainLoad plain{};
  if constexpr (V == kLayerWarp8) {
    // a group of 8 lanes per query; all lanes of a warp run every step
    const int64_t qi = i / 8;
    const int j = threadIdx.x % 8;
    const int shift = (threadIdx.x % 32) & ~7;
    const bool live = qi < p.n_q;
    const int64_t q = live ? __ldcs(reinterpret_cast<const long long*>(p.q) + qi)
                           : 0;
    int32_t lo = 0, hi = 0;
    if (live) layer<KIND>(kept, p, q, lo, hi);
    hi = min(hi, p.n_spline - 1);
    for (int32_t step = 0; step < p.search_trips; ++step) {
      const int32_t n = hi - lo + 1;
      const bool cut = live && n > 8;
      const int32_t pj = lo + static_cast<int32_t>(
          (static_cast<int64_t>(j + 1) * n) / 9);
      const bool le = cut && kept.key(p.sk + pj) <= q;
      const unsigned bits = (__ballot_sync(0xffffffffu, le) >> shift) & 0xffu;
      const int c = __popc(bits);
      if (cut) {
        const int32_t pc = lo + static_cast<int32_t>(
            (static_cast<int64_t>(c + 1) * n) / 9);
        const int32_t pc1 = lo + static_cast<int32_t>(
            (static_cast<int64_t>(c) * n) / 9);
        hi = c < 8 ? pc - 1 : hi;
        lo = c > 0 ? pc1 : lo;
      }
    }
    const bool in = live && lo + j <= hi;
    const bool le = in && kept.key(p.sk + lo + j) <= q;
    const int c = __popc((__ballot_sync(0xffffffffu, le) >> shift) & 0xffu);
    if (live && j == 0) p.out[qi] = lo + max(c - 1, 0);
    return;
  } else if constexpr (V == kLayerSmem) {
    extern __shared__ int32_t level0[];
    const int32_t n0 = 1 << p.r;
    for (int32_t t = threadIdx.x; t < n0; t += blockDim.x)
      level0[t] = kept.i32(reinterpret_cast<const int32_t*>(p.cells) + t);
    __syncthreads();
    if (i >= p.n_q) return;
    const int64_t q = __ldcs(reinterpret_cast<const long long*>(p.q) + i);
    const uint64_t k = static_cast<uint64_t>(q) ^ 0x8000000000000000ull;
    uint32_t cell = static_cast<uint32_t>(level0[k >> (64 - p.r)]);
    int32_t val = static_cast<int32_t>(cell & 0x7FFFFFFFu);
    int64_t node = val;
    for (int32_t lvl = 1; (cell >> 31) && lvl < p.levels; ++lvl) {
      const uint32_t bin = static_cast<uint32_t>((k << (lvl * p.r)) >>
                                                 (64 - p.r));
      cell = static_cast<uint32_t>(kept.i32(
          reinterpret_cast<const int32_t*>(p.cells) + (node << p.r) + bin));
      val = static_cast<int32_t>(cell & 0x7FFFFFFFu);
      node = val;
    }
    if (cell >> 31) val = 0;
    const int32_t lo = val;
    const int32_t hi = min(lo + p.delta, p.n_spline - 1);
    __stcs(p.out + i, lo + hi);
    return;
  } else {
    if (i >= p.n_q) return;
    const int64_t q = __ldcs(reinterpret_cast<const long long*>(p.q) + i);
    int32_t lo, hi, r;
    if constexpr (V == kStream) {
      r = static_cast<int32_t>(q);
    } else if constexpr (V == kWholePlain || V == kFusedPlain) {
      layer<KIND>(plain, p, q, lo, hi);
      r = segment_base(plain, p.sk, p.spos, p.n_spline, q,
                       adaptive_predecessor(plain, p.sk, p.n_spline, q, lo,
                                            hi),
                       p.eps_eff, p.base_max);
      if (V == kFusedPlain)
        r = static_cast<int32_t>(summary_lower_bound<1>(
            p.dk, p.s1, p.s2, p.n_row, p.n1, q, r, p.window, kept.pol));
    } else if constexpr (V == kLayerBisectX2) {
      // queries i and i + half in one thread, their chains interleaved
      const int64_t half = (p.n_q + 1) / 2;
      if (i >= half) return;
      const int64_t i2 = i + half;
      const bool two = i2 < p.n_q;
      const int64_t q2 = two ? __ldcs(reinterpret_cast<const long long*>(p.q) +
                                      i2)
                             : q;
      int32_t lo2, hi2;
      layer<KIND>(kept, p, q, lo, hi);
      layer<KIND>(kept, p, q2, lo2, hi2);
      for (int32_t t = 0; t < p.search_trips; ++t) {
        const int32_t m1 = (lo + hi + 1) >> 1;
        const int32_t m2 = (lo2 + hi2 + 1) >> 1;
        const int64_t k1 = kept.key(p.sk + min(m1, p.n_spline - 1));
        const int64_t k2 = kept.key(p.sk + min(m2, p.n_spline - 1));
        const bool g1 = k1 <= q;
        const bool g2 = k2 <= q2;
        lo = g1 ? m1 : lo;
        hi = g1 ? hi : m1 - 1;
        lo2 = g2 ? m2 : lo2;
        hi2 = g2 ? hi2 : m2 - 1;
      }
      if (two) __stcs(p.out + i2, lo2);
      r = lo;
    } else {
      layer<KIND>(kept, p, q, lo, hi);
      if constexpr (V == kLayer) {
        r = lo + hi;
      } else if constexpr (V == kLayerCount) {
        r = spline_predecessor<kCount>(kept, p.sk, p.n_spline, q, lo, hi,
                                       p.search_width, p.search_trips);
      } else if constexpr (V == kLayerBisect) {
        r = spline_predecessor<kBisect>(kept, p.sk, p.n_spline, q, lo, hi,
                                        p.search_width, p.search_trips);
      } else if constexpr (V == kLayerAdaptive) {
        r = adaptive_predecessor(kept, p.sk, p.n_spline, q, lo, hi).seg;
      } else {
        r = segment_predecessor(kept, p.sk, p.n_spline, q, lo, hi);
      }
    }
    if constexpr (V == kStream || V == kWholePlain || V == kFusedPlain)
      p.out[i] = r;
    else
      __stcs(p.out + i, r);
  }
}

template <int KIND, int V>
static void launch(const SegParams& p, size_t smem, cudaStream_t st) {
  int64_t threads = V == kLayerWarp8 ? p.n_q * 8 : p.n_q;
  if (V == kLayerBisectX2) threads = (p.n_q + 1) / 2;
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  split_kernel<KIND, V><<<blocks, 256, smem, st>>>(p);
}

template <int KIND>
static int pick(const SegParams& p, int v, cudaStream_t st) {
  switch (v) {
    case kStream: launch<KIND, kStream>(p, 0, st); break;
    case kLayer: launch<KIND, kLayer>(p, 0, st); break;
    case kLayerCount: launch<KIND, kLayerCount>(p, 0, st); break;
    case kLayerBisect: launch<KIND, kLayerBisect>(p, 0, st); break;
    case kLayerAdaptive: launch<KIND, kLayerAdaptive>(p, 0, st); break;
    case kLayerSegment: launch<KIND, kLayerSegment>(p, 0, st); break;
    case kLayerBisectX2: launch<KIND, kLayerBisectX2>(p, 0, st); break;
    case kLayerWarp8: launch<KIND, kLayerWarp8>(p, 0, st); break;
    case kWholePlain: launch<KIND, kWholePlain>(p, 0, st); break;
    case kFusedPlain: launch<KIND, kFusedPlain>(p, 0, st); break;
    case kLayerSmem: {
      const size_t smem = sizeof(int32_t) << p.r;
      if (KIND != 1 || smem > 48 * 1024)
        return static_cast<int>(cudaErrorInvalidValue);
      launch<KIND, kLayerSmem>(p, smem, st);
      break;
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_split(const SegParams* p, int cht, int variant,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cht ? pick<1>(*p, variant, st) : pick<0>(*p, variant, st);
}

extern "C" int segment_split_params_size() {
  return static_cast<int>(sizeof(SegParams));
}
