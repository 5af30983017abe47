// Variants of the summary probe (csrc/plex_device.cuh) that split its time
// on the card: each part alone, and the design elements left out. A
// measurement aid for tools/probe_split.py, not part of the port.
#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

struct SplitParams {
  // field order mirrors _Params in probe_split.py
  const int64_t* dk;
  const int64_t* s1;
  const int64_t* s2;
  const int64_t* q;
  const int32_t* base;
  const int64_t* given;  // variants 3, 4: a level-1 sample / an answer
  int64_t* sample_out;   // variant 2: the level-1 sample found
  int32_t* out;
  int64_t n_q;
  int64_t n_row;
  int64_t n1;
  int32_t window;
};

// last_sample_below and the segment count with plain loads (no L2 policy,
// no evict-first)
__device__ __forceinline__ int64_t last_below_plain(const int64_t* s,
                                                    int64_t lo, int64_t hi,
                                                    int64_t q) {
  int64_t a = lo - 1;
  int64_t b = hi;
  while (a < b) {
    const int64_t mid = (a + b + 1) >> 1;
    if (s[mid] < q) a = mid;
    else b = mid - 1;
  }
  return a;
}

__device__ __forceinline__ int32_t count_plain(const int64_t* plane,
                                               int64_t start, int64_t lo,
                                               int64_t hi, int64_t q) {
  if (lo >= hi) return 0;
  const longlong2* v = reinterpret_cast<const longlong2*>(plane + start);
  int32_t c = 0;
#pragma unroll
  for (int k = 0; k < kSegment / 2; ++k) {
    const longlong2 w = v[k];
    const int64_t j = start + 2 * k;
    c += (j >= lo && j < hi && w.x < q);
    c += (j + 1 >= lo && j + 1 < hi && w.y < q);
  }
  return c;
}

// 0, 1: the probe with one, two levels; 2: level-1 bisect alone; 3: the data
// segment alone, from a given sample; 4: one 8-byte read at a given answer;
// 5, 6: one, two levels without cache hints; 7: two levels, the level-2
// samples of the window counted by independent loads instead of bisected.
template <int V>
__global__ void __launch_bounds__(256) split_kernel(const SplitParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_q) return;
  const int64_t q = p.q[i];
  const int64_t base = p.base[i];
  const int64_t last = base + p.window - 1;
  const int64_t i0 = (base + kSegment - 1) / kSegment;
  const int64_t i1 = last / kSegment;
  constexpr int64_t kStride2 = kSegment * kSegment;
  int64_t r = 0;
  if constexpr (V == 0 || V == 1) {
    r = summary_lower_bound<V + 1>(p.dk, p.s1, p.s2, p.n_row, p.n1, q, base,
                                   p.window, summary_policy());
  } else if constexpr (V == 2) {
    r = last_sample_below(p.s1, i0, i1, q, summary_policy());
    p.sample_out[i] = r;
  } else if constexpr (V == 3) {
    const int64_t k1 = p.given[i];
    const int64_t lo = max(k1 * kSegment, base);
    const int64_t hi = min(k1 * kSegment + kSegment, base + p.window);
    r = lo + count_below_in_segment(p.dk, k1 * kSegment, p.n_row, lo, hi, q);
  } else if constexpr (V == 4) {
    r = p.dk[p.given[i]];
  } else {
    int64_t k1;
    if constexpr (V == 5) {
      k1 = last_below_plain(p.s1, i0, i1, q);
    } else {
      int64_t k2;
      if constexpr (V == 6) {
        k2 = last_below_plain(p.s2, (base + kStride2 - 1) / kStride2,
                              last / kStride2, q);
      } else {
        const uint64_t pol = summary_policy();
        const int64_t c2 = (base + kStride2 - 1) / kStride2;
        const int64_t f2 = last / kStride2;
        int32_t c = 0;
        for (int64_t t = c2; t <= f2; ++t) c += (load_kept(p.s2 + t, pol) < q);
        k2 = c2 - 1 + c;
      }
      const int64_t lo = max(k2 * kSegment, i0);
      const int64_t hi = min(k2 * kSegment + kSegment, i1 + 1);
      k1 = lo - 1 + (V == 6 ? count_plain(p.s1, k2 * kSegment, lo, hi, q)
                            : count_below_in_segment(p.s1, k2 * kSegment,
                                                     p.n1, lo, hi, q));
    }
    const int64_t lo = max(k1 * kSegment, base);
    const int64_t hi = min(k1 * kSegment + kSegment, base + p.window);
    r = lo + (V == 7 ? count_below_in_segment(p.dk, k1 * kSegment, p.n_row,
                                              lo, hi, q)
                     : count_plain(p.dk, k1 * kSegment, lo, hi, q));
  }
  p.out[i] = static_cast<int32_t>(r);
}

template <int V>
static void launch(const SplitParams& p, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((p.n_q + 255) / 256);
  split_kernel<V><<<blocks, 256, 0, st>>>(p);
}

extern "C" int probe_split(const SplitParams* p, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: launch<0>(*p, st); break;
    case 1: launch<1>(*p, st); break;
    case 2: launch<2>(*p, st); break;
    case 3: launch<3>(*p, st); break;
    case 4: launch<4>(*p, st); break;
    case 5: launch<5>(*p, st); break;
    case 6: launch<6>(*p, st); break;
    case 7: launch<7>(*p, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
