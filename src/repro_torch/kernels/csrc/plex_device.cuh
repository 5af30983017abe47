// Device functions shared by the port's PLEX kernels (sm_90a):
// stacked_lookup.cu (K1), segment_lookup.cu (K2, K3), bounded_search.cu (K4).
//
// Keys are biased int64 (k ^ 2^63): signed order is the unsigned order, and
// the u64 difference of two keys is their wrapping int64 difference.
// Bit-exactness with the reference: the interpolation uses __fsub_rn,
// __fmul_rn, __fdiv_rn and __fadd_rn so nothing contracts into an FMA or a
// fast division (the build adds --fmad=false as well), and a u64 difference
// becomes float32 exactly as repro/kernels/pairs.py::pair_to_f32 does it:
// f32(hi) * 2^32 + f32(lo), each step rounded to nearest.
#pragma once

#include <cstdint>

// f32(hi) * 2^32 + f32(lo), each step rounded to nearest (pair_to_f32)
__device__ __forceinline__ float u64_to_f32_pair(uint64_t d) {
  const float hi = __uint2float_rn(static_cast<uint32_t>(d >> 32));
  const float lo = __uint2float_rn(static_cast<uint32_t>(d));
  return __fadd_rn(__fmul_rn(hi, 4294967296.0f), lo);
}

__device__ __forceinline__ uint64_t key_diff(int64_t a, int64_t b) {
  return static_cast<uint64_t>(a) - static_cast<uint64_t>(b);
}

// Radix prefix of K1, as the reference computes it: the low 32 bits of
// (q - min) >> shift (0 below min), cast to int32 (a huge absent key can
// wrap, negative or to an arbitrary bucket), clipped to [0, p_max].
__device__ __forceinline__ int32_t radix_prefix_wrapped(int64_t q,
                                                        int64_t min_key,
                                                        int32_t shift,
                                                        int32_t p_max) {
  const uint64_t d = (q < min_key) ? 0ull : key_diff(q, min_key);
  const int32_t pfx = static_cast<int32_t>(static_cast<uint32_t>(d >> shift));
  return min(max(pfx, 0), p_max);
}

// Radix prefix of K2: the whole (q - min) >> shift (0 below min), clipped
// to p_max, so a key far past the last one lands in the last bucket
// (ROADMAP queue 3, R5: the reference's wrap misroutes it).
__device__ __forceinline__ int32_t radix_prefix(int64_t q, int64_t min_key,
                                                int32_t shift, int32_t p_max) {
  const uint64_t d = (q < min_key) ? 0ull : key_diff(q, min_key);
  const uint64_t pfx = d >> shift;
  return pfx < static_cast<uint64_t>(p_max) ? static_cast<int32_t>(pfx) : p_max;
}

// Radix-table window [lo, hi] of spline indices for prefix p.
__device__ __forceinline__ void table_window(const int32_t* table, int32_t p,
                                             int32_t& lo, int32_t& hi) {
  lo = max(__ldg(table + p) - 1, 0);
  hi = max(__ldg(table + p + 1) - 1, 0);
}

// CHT descent over `levels` cells (top bit = child): the terminal value q~.
// Bins come from the unbiased key: (k << lvl*r) >> (64 - r).
__device__ __forceinline__ int32_t cht_descend(const uint32_t* cells,
                                               int64_t q, int32_t r,
                                               int32_t levels) {
  const uint64_t k = static_cast<uint64_t>(q) ^ 0x8000000000000000ull;
  int64_t node = 0;
  int32_t val = 0;
  for (int32_t lvl = 0; lvl < levels; ++lvl) {
    const uint32_t bin = static_cast<uint32_t>((k << (lvl * r)) >> (64 - r));
    const uint32_t cell = __ldg(cells + (node << r) + bin);
    val = static_cast<int32_t>(cell & 0x7FFFFFFFu);
    if (!(cell >> 31)) return val;  // terminal: the rounds left are no-ops
    node = val;
    val = 0;
  }
  return val;
}

// Spline predecessor: largest i in [lo, hi] with sk[i] <= q (lo when none
// is), by a count over at most `width` keys or by `trips` bisect rounds.
// `sk` is the spline row of `ns` keys; every read is clamped to it.
template <bool BISECT>
__device__ __forceinline__ int32_t spline_predecessor(
    const int64_t* sk, int32_t ns, int64_t q, int32_t lo, int32_t hi,
    int32_t width, int32_t trips) {
  if (!BISECT) {
    const int32_t last = min(hi - lo, width - 1);
    int32_t cnt = 0;
    for (int32_t j = 0; j <= last; ++j) cnt += (sk[min(lo + j, ns - 1)] <= q);
    return lo + max(cnt - 1, 0);
  }
  for (int32_t t = 0; t < trips; ++t) {
    const int32_t mid = (lo + hi + 1) >> 1;
    const bool go = sk[min(mid, ns - 1)] <= q;
    lo = go ? mid : lo;
    hi = go ? hi : mid - 1;
  }
  return lo;
}

// Window base of the eps probe: float32 interpolation at segment `seg`
// (clipped to [0, ns - 2] in min(max(.)) order), then
// clip(floor(pred) - eps_eff, 0, base_max).
__device__ __forceinline__ int32_t segment_base(const int64_t* sk,
                                                const float* spos, int32_t ns,
                                                int64_t q, int32_t seg,
                                                int32_t eps_eff,
                                                int32_t base_max) {
  const int32_t g = min(max(seg, 0), ns - 2);
  const int64_t x0 = sk[g];
  const int64_t x1 = sk[g + 1];
  const float y0 = spos[g];
  const float y1 = spos[g + 1];
  const float dx = fmaxf(u64_to_f32_pair(key_diff(x1, x0)), 1.0f);
  // a query below the segment start snaps to t = 0
  const float dq = (q < x0) ? 0.0f : u64_to_f32_pair(key_diff(q, x0));
  const float tt = fminf(fmaxf(__fdiv_rn(dq, dx), 0.0f), 1.0f);
  const float pred = __fadd_rn(y0, __fmul_rn(tt, __fsub_rn(y1, y0)));
  const int32_t base = static_cast<int32_t>(floorf(pred)) - eps_eff;
  return min(max(base, 0), base_max);
}

// Eps-window probe: first index in [base, base + window] whose key is >= q
// (base + window when every window key is < q), by a count over the window
// or by `trips` = bit_length(window) bisect rounds; identical results.
template <bool BISECT>
__device__ __forceinline__ int64_t window_lower_bound(const int64_t* dk,
                                                      int64_t q, int64_t base,
                                                      int32_t window,
                                                      int32_t trips) {
  if (!BISECT) {
    const int64_t* w = dk + base;
    int32_t c = 0;
    for (int32_t j = 0; j < window; ++j) c += (w[j] < q);
    return base + c;
  }
  int64_t lo = base;
  int64_t hi = base + window - 1;
  for (int32_t t = 0; t < trips; ++t) {
    const int64_t mid = (lo + hi) >> 1;
    const bool ge = !(dk[mid] < q);
    hi = ge ? mid : hi;
    lo = ge ? lo : mid + 1;
  }
  return lo;
}
