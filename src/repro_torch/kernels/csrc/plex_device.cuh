// Device functions shared by the port's PLEX kernels (sm_90a):
// stacked_lookup.cu (K1), segment_lookup.cu (K2, K3, and K2/K3 fused with
// K4), bounded_search.cu (K4).
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

// ---- loads of the small planes ---------------------------------------------
//
// The spline keys and ranks, the radix table and the CHT cells are read
// through a loader: PlainLoad (K1: plain loads, the table and cells through
// the read-only path) or KeptLoad (K2/K3: an L2 evict_last policy, so the
// stream of queries, bases and data segments does not push them out of L2).

constexpr int kSegment = 8;  // keys a sample stands for: 64 bytes

// L2 policy for loads of data to keep: evict its lines last.
__device__ __forceinline__ uint64_t summary_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int64_t load_kept(const int64_t* p, uint64_t pol) {
  int64_t v;
  asm("ld.global.nc.L2::cache_hint.b64 %0, [%1], %2;"
      : "=l"(v) : "l"(p), "l"(pol));
  return v;
}

struct PlainLoad {
  __device__ __forceinline__ int64_t key(const int64_t* p) const { return *p; }
  __device__ __forceinline__ float rank(const float* p) const { return *p; }
  __device__ __forceinline__ int32_t i32(const int32_t* p) const {
    return __ldg(p);
  }
};

struct KeptLoad {
  uint64_t pol;
  __device__ __forceinline__ int64_t key(const int64_t* p) const {
    return load_kept(p, pol);
  }
  __device__ __forceinline__ float rank(const float* p) const {
    float v;
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v) : "l"(p), "l"(pol));
    return v;
  }
  __device__ __forceinline__ int32_t i32(const int32_t* p) const {
    int32_t v;
    asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
        : "=r"(v) : "l"(p), "l"(pol));
    return v;
  }
};

// Radix-table window [lo, hi] of spline indices for query q: the table
// pair at the prefix (q - min) >> shift (0 below min), the whole shifted
// difference saturated at p_max. The reference keeps its low 32 bits, cast
// to int32, which misroutes a key far past the last one (ROADMAP queue 3,
// R5); below 2^31 the two are equal.
template <class L>
__device__ __forceinline__ void radix_window(const L& ld, const int32_t* table,
                                             int64_t q, int64_t min_key,
                                             int32_t shift, int32_t p_max,
                                             int32_t& lo, int32_t& hi) {
  const uint64_t d = (q < min_key) ? 0ull : key_diff(q, min_key);
  const uint64_t pfx = d >> shift;
  const int32_t p =
      pfx < static_cast<uint64_t>(p_max) ? static_cast<int32_t>(pfx) : p_max;
  lo = max(ld.i32(table + p) - 1, 0);
  hi = max(ld.i32(table + p + 1) - 1, 0);
}

// CHT descent over `levels` cells (top bit = child): the terminal value q~.
// Bins come from the unbiased key: (k << lvl*r) >> (64 - r).
template <class L>
__device__ __forceinline__ int32_t cht_descend(const L& ld,
                                               const uint32_t* cells,
                                               int64_t q, int32_t r,
                                               int32_t levels) {
  const uint64_t k = static_cast<uint64_t>(q) ^ 0x8000000000000000ull;
  const int32_t* c = reinterpret_cast<const int32_t*>(cells);
  int64_t node = 0;
  int32_t val = 0;
  for (int32_t lvl = 0; lvl < levels; ++lvl) {
    const uint32_t bin = static_cast<uint32_t>((k << (lvl * r)) >> (64 - r));
    const uint32_t cell = static_cast<uint32_t>(ld.i32(c + (node << r) + bin));
    val = static_cast<int32_t>(cell & 0x7FFFFFFFu);
    if (!(cell >> 31)) return val;  // terminal: the rounds left are no-ops
    node = val;
    val = 0;
  }
  return val;
}

// Spline search forms (identical predecessors).
enum { kCount = 0, kBisect = 1, kAdaptive = 2 };

// Spline predecessor: largest i in [lo, hi] with sk[i] <= q, lo when none
// is, by the reference's count over at most `width` keys (kCount) or its
// `trips` fixed bisect rounds (kBisect). `sk` is the spline row of `ns`
// keys; every read is clamped to it. kAdaptive is adaptive_predecessor.
template <int FORM, class L>
__device__ __forceinline__ int32_t spline_predecessor(
    const L& ld, const int64_t* sk, int32_t ns, int64_t q, int32_t lo,
    int32_t hi, int32_t width, int32_t trips) {
  if constexpr (FORM == kCount) {
    const int32_t last = min(hi - lo, width - 1);
    int32_t cnt = 0;
    for (int32_t j = 0; j <= last; ++j)
      cnt += (ld.key(sk + min(lo + j, ns - 1)) <= q);
    return lo + max(cnt - 1, 0);
  } else {
    for (int32_t t = 0; t < trips; ++t) {
      const int32_t mid = (lo + hi + 1) >> 1;
      const bool go = ld.key(sk + min(mid, ns - 1)) <= q;
      lo = go ? mid : lo;
      hi = go ? hi : mid - 1;
    }
    return lo;
  }
}

// The adaptive form's predecessor, and the keys at it and after it where a
// probe read them (flags say which).
struct Predecessor {
  int32_t seg;
  bool has_x0, has_x1;
  int64_t x0, x1;  // sk[seg], sk[seg + 1]
};

// kAdaptive: the predecessor by bisect rounds until the window closes (a
// warp runs until its widest window does, not the widest of the planes),
// keeping the key of the last probe that moved lo (sk[seg]) and of the last
// that moved hi (sk[seg + 1]) for the interpolation, which then reads only
// the two ranks where both were probed. hi is first clipped to ns - 1:
// where the reference's forms read the last key again instead, their
// predecessor is past ns - 2 too, and the interpolation clips every form's
// to ns - 2, so all give the same base.
template <class L>
__device__ __forceinline__ Predecessor adaptive_predecessor(
    const L& ld, const int64_t* sk, int32_t ns, int64_t q, int32_t lo,
    int32_t hi) {
  Predecessor r{0, false, false, 0, 0};
  hi = min(hi, ns - 1);
  while (lo < hi) {
    const int32_t mid = (lo + hi + 1) >> 1;
    const int64_t k = ld.key(sk + mid);
    if (k <= q) {
      lo = mid;
      r.x0 = k;
      r.has_x0 = true;
    } else {
      hi = mid - 1;
      r.x1 = k;
      r.has_x1 = true;
    }
  }
  r.seg = lo;
  return r;
}

// Window base of the eps probe: float32 interpolation at segment `seg`
// (clipped to [0, ns - 2] in min(max(.)) order), then
// clip(floor(pred) - eps_eff, 0, base_max); the second form takes the keys
// an adaptive search already read.
template <class L>
__device__ __forceinline__ int32_t segment_base(const L& ld, const int64_t* sk,
                                                const float* spos, int32_t ns,
                                                int64_t q,
                                                const Predecessor& pr,
                                                int32_t eps_eff,
                                                int32_t base_max) {
  const int32_t g = min(max(pr.seg, 0), ns - 2);
  const bool at = g == pr.seg;  // keys probed at seg are the segment's
  const int64_t x0 = at && pr.has_x0 ? pr.x0 : ld.key(sk + g);
  const int64_t x1 = at && pr.has_x1 ? pr.x1 : ld.key(sk + g + 1);
  const float y0 = ld.rank(spos + g);
  const float y1 = ld.rank(spos + g + 1);
  const float dx = fmaxf(u64_to_f32_pair(key_diff(x1, x0)), 1.0f);
  // a query below the segment start snaps to t = 0
  const float dq = (q < x0) ? 0.0f : u64_to_f32_pair(key_diff(q, x0));
  const float tt = fminf(fmaxf(__fdiv_rn(dq, dx), 0.0f), 1.0f);
  const float pred = __fadd_rn(y0, __fmul_rn(tt, __fsub_rn(y1, y0)));
  const int32_t base = static_cast<int32_t>(floorf(pred)) - eps_eff;
  return min(max(base, 0), base_max);
}

template <class L>
__device__ __forceinline__ int32_t segment_base(const L& ld, const int64_t* sk,
                                                const float* spos, int32_t ns,
                                                int64_t q, int32_t seg,
                                                int32_t eps_eff,
                                                int32_t base_max) {
  return segment_base(ld, sk, spos, ns, q,
                      Predecessor{seg, false, false, 0, 0}, eps_eff,
                      base_max);
}

// Eps-window probe as the reference writes it: first index in
// [base, base + window] whose key is >= q (base + window when every window
// key is < q), by a count over the window or by `trips` =
// bit_length(window) bisect rounds; identical results. K1 and K4 run the
// count form; the bisect form serves K1's delta fold (at most 4096 keys,
// which stay in L2). Their bisect form is summary_lower_bound below.
template <bool BISECT>
__device__ __forceinline__ int64_t window_lower_bound(const int64_t* dk,
                                                      int64_t q, int64_t base,
                                                      int32_t window,
                                                      int32_t trips) {
  if constexpr (!BISECT) {
    const int64_t* w = dk + base;
    int32_t c = 0;
    for (int32_t j = 0; j < window; ++j) c += (w[j] < q);
    return base + c;
  } else {
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
}

// ---- the summary probe (K1's and K4's bisect form) -------------------------
//
// The summary of a data-plane row holds its every 8th key (level 1) and its
// every 64th key (level 2), each sampled from the row's start. The probe
// bisects the window's samples, which an L2 evict_last policy keeps in L2,
// and then reads the one 8-key (64-byte) segment of the data plane that the
// last sample below q starts (two levels: the 64-byte segment of level 1
// first), evict-first, so the data stream does not push the summary out.

// Largest i in [lo, hi] with s[i] < q, else lo - 1: a bisect over samples
// kept in L2 (at most bit_length(hi - lo + 1) trips).
__device__ __forceinline__ int64_t last_sample_below(const int64_t* s,
                                                     int64_t lo, int64_t hi,
                                                     int64_t q, uint64_t pol) {
  int64_t a = lo - 1;
  int64_t b = hi;
  while (a < b) {
    const int64_t mid = (a + b + 1) >> 1;
    if (load_kept(s + mid, pol) < q) a = mid;
    else b = mid - 1;
  }
  return a;
}

// #{j in [lo, hi) : plane[j] < q} for [lo, hi) inside the segment
// [start, start + 8) of a `len`-entry row: a whole, 16-byte aligned segment
// is read as four 16-byte evict-first loads, a partial one key by key.
__device__ __forceinline__ int32_t count_below_in_segment(
    const int64_t* plane, int64_t start, int64_t len, int64_t lo, int64_t hi,
    int64_t q) {
  if (lo >= hi) return 0;
  int32_t c = 0;
  const int64_t* seg = plane + start;
  if (start + kSegment <= len &&
      (reinterpret_cast<uintptr_t>(seg) & 15) == 0) {
    const longlong2* v = reinterpret_cast<const longlong2*>(seg);
#pragma unroll
    for (int k = 0; k < kSegment / 2; ++k) {
      const longlong2 w = __ldcs(v + k);
      const int64_t j = start + 2 * k;
      c += (j >= lo && j < hi && w.x < q);
      c += (j + 1 >= lo && j + 1 < hi && w.y < q);
    }
  } else {
    for (int64_t j = lo; j < hi; ++j)
      c += (__ldcs(reinterpret_cast<const long long*>(plane + j)) < q);
  }
  return c;
}

// First row-local index in [base, base + window] whose key is >= q, as
// window_lower_bound gives it. `dk` is the query's data-plane row of `n_row`
// keys; `s1`, `s2` its summary rows (`n1` level-1 samples a row). LEVELS 1:
// bisect the level-1 samples of the window (at most ceil(window / 8), all in
// L2), then one data segment. LEVELS 2: bisect the level-2 samples, count in
// the level-1 segment the last one starts, then one data segment. When no
// sample is below q, the segment taken is the one that ends at the window's
// first sample; the sample after the segment is >= q, so no other key is
// needed.
template <int LEVELS>
__device__ __forceinline__ int64_t summary_lower_bound(
    const int64_t* dk, const int64_t* s1, const int64_t* s2, int64_t n_row,
    int64_t n1, int64_t q, int64_t base, int32_t window, uint64_t pol) {
  const int64_t last = base + window - 1;
  const int64_t i0 = (base + kSegment - 1) / kSegment;
  const int64_t i1 = last / kSegment;
  int64_t k1;
  if (LEVELS == 1) {
    k1 = last_sample_below(s1, i0, i1, q, pol);
  } else {
    constexpr int64_t kStride2 = kSegment * kSegment;
    const int64_t k2 = last_sample_below(
        s2, (base + kStride2 - 1) / kStride2, last / kStride2, q, pol);
    const int64_t lo = max(k2 * kSegment, i0);
    const int64_t hi = min(k2 * kSegment + kSegment, i1 + 1);
    k1 = lo - 1 + count_below_in_segment(s1, k2 * kSegment, n1, lo, hi, q);
  }
  const int64_t lo = max(k1 * kSegment, base);
  const int64_t hi = min(k1 * kSegment + kSegment, base + window);
  return lo + count_below_in_segment(dk, k1 * kSegment, n_row, lo, hi, q);
}
