// Fused stacked PLEX lookup for Hopper (sm_90a): one thread per query.
//
// Replaces the TPU kernel repro/kernels/stacked_pallas.py::stacked_pallas_lookup
// (body _kernel_body -> jnp_lookup._stacked_pipeline + delta_rank_adjust).
// Per query: route to a shard -> radix-table or CHT window over the spline
// points -> spline predecessor (count or bisect) -> float32 interpolation ->
// eps-window probe of the data keys (count or bisect) -> clamp to the shard's
// real key count + its global row offset -> (+ delta fold when FOLD).
//
// What bounds it: bytes gathered per query. Each query reads its own 8-byte
// key and writes a 4-byte rank, but in between it gathers from planes far
// larger than any cache: a few 4-byte table or CHT cells, one to ~10 8-byte
// spline keys (bisect) or up to the window width (count), two spline points
// with their ranks for the interpolation, and then the data probe: ~9 8-byte
// keys by bisect over a 256-key window at eps 64, or all 256 by count. Every
// gather is a dependent, uncoalesced 32-byte sector read from device memory
// (neighbouring threads hold unrelated keys), so the kernel is latency- and
// sector-bound rather than FLOP-bound; the arithmetic is a few dozen integer
// ops and five float ops per query.
//
// What the design does about it: one thread per query with no shared state,
// so the card keeps as many queries in flight as its registers allow and
// hides gather latency by occupancy; every per-shard scalar is read through
// the read-only path (__ldg); the shard-minima, geometry and table planes are
// small and stay in L1/L2; bisect reads log2(width) keys where count reads
// width of them. The Pallas kernel loaded every plane as a whole VMEM block;
// that was a TPU limit and is not carried over: planes stay in global memory.
//
// Bit-exactness with the reference: the interpolation uses __fsub_rn,
// __fmul_rn, __fdiv_rn and __fadd_rn so nothing contracts into an FMA or a
// fast division, and a u64 difference becomes float32 exactly as
// repro/kernels/pairs.py::pair_to_f32 does it: f32(hi) * 2^32 + f32(lo).
// Keys are biased int64 (k ^ 2^63): signed order is the unsigned order, and
// the u64 difference of two keys is their wrapping int64 difference.

#include <cstdint>
#include <cuda_runtime.h>

struct PlexParams {
  // pointers (field order mirrors _Params in stacked_lookup.py)
  const int64_t* q;
  const int64_t* sk;
  const float* spos;
  const int64_t* dk;
  const int32_t* n_spline;
  const int32_t* n_real;
  const int32_t* row_off;
  const int64_t* shard_min;
  const int32_t* table;
  const int32_t* table_off;
  const int32_t* shift;
  const int32_t* p_max;
  const int64_t* lmin;
  const uint32_t* cells;
  const int32_t* cells_off;
  const int32_t* delta;
  const int64_t* dkeys;
  const int32_t* dcum;
  int32_t* out;
  int32_t* sid_out;   // nullable: routed shard id per query
  int32_t* base_out;  // nullable: local eps-window base per query
  int64_t n_q;
  int64_t n_spline_max;
  int64_t n_data_max;
  int32_t n_shards;
  int32_t eps_eff;
  int32_t window;
  int32_t search_width;  // spline window the count mode covers
  int32_t search_trips;  // bisect trips over the spline window
  int32_t probe_trips;   // bit_length(window)
  int32_t r;             // CHT radix bits
  int32_t levels;        // CHT levels (deepest shard)
  int32_t cap;           // delta capacity (FOLD only)
  int32_t delta_trips;   // bit_length(cap)
};

enum { kRadix = 0, kCht = 1 };

// f32(hi) * 2^32 + f32(lo), each step rounded to nearest (pair_to_f32)
__device__ __forceinline__ float u64_to_f32_pair(uint64_t d) {
  const float hi = __uint2float_rn(static_cast<uint32_t>(d >> 32));
  const float lo = __uint2float_rn(static_cast<uint32_t>(d));
  return __fadd_rn(__fmul_rn(hi, 4294967296.0f), lo);
}

__device__ __forceinline__ uint64_t key_diff(int64_t a, int64_t b) {
  return static_cast<uint64_t>(a) - static_cast<uint64_t>(b);
}

template <int KIND, bool SPLINE_BISECT, bool PROBE_BISECT, bool FOLD>
__global__ void __launch_bounds__(256)
stacked_lookup_kernel(const PlexParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_q) return;
  const int64_t q = p.q[i];

  // 1. route: #{shard minima <= q} - 1, clipped to [0, S - 1]
  int32_t s = 0;
  if (p.n_shards > 1) {
    int32_t cnt = 0;
    for (int32_t j = 0; j < p.n_shards; ++j) cnt += (__ldg(p.shard_min + j) <= q);
    s = min(max(cnt - 1, 0), p.n_shards - 1);
  }
  const int32_t ns = __ldg(p.n_spline + s);
  const int64_t srow = static_cast<int64_t>(s) * p.n_spline_max;

  // 2. window [lo, hi] of local spline indices
  int32_t lo, hi;
  if (KIND == kRadix) {
    const int64_t lm = __ldg(p.lmin + s);
    const uint64_t d = (q < lm) ? 0ull : key_diff(q, lm);
    // low 32 bits of the shifted difference, cast to int32 (may go negative)
    const int32_t pfx = static_cast<int32_t>(static_cast<uint32_t>(d >> __ldg(p.shift + s)));
    const int32_t pp = min(max(pfx, 0), __ldg(p.p_max + s));
    const int64_t t = static_cast<int64_t>(__ldg(p.table_off + s)) + pp;
    lo = max(__ldg(p.table + t) - 1, 0);
    hi = max(__ldg(p.table + t + 1) - 1, 0);
  } else {
    // bins come from the unbiased key: (k << lvl*r) >> (64 - r)
    const uint64_t k = static_cast<uint64_t>(q) ^ 0x8000000000000000ull;
    const int64_t coff = __ldg(p.cells_off + s);
    int64_t node = 0;
    int32_t val = 0;
    for (int32_t lvl = 0; lvl < p.levels; ++lvl) {
      const uint32_t bin = static_cast<uint32_t>((k << (lvl * p.r)) >> (64 - p.r));
      const uint32_t cell = __ldg(p.cells + coff + (node << p.r) + bin);
      val = static_cast<int32_t>(cell & 0x7FFFFFFFu);
      if (!(cell >> 31)) break;  // terminal: the rounds left are no-ops
      node = val;
      val = 0;
    }
    lo = val;
    hi = min(val + __ldg(p.delta + s), ns - 1);
  }

  // 3. spline predecessor: largest i in [lo, hi] with sk[i] <= q
  int32_t seg;
  if (!SPLINE_BISECT) {
    const int32_t last = min(hi - lo, p.search_width - 1);
    int32_t cnt = 0;
    for (int32_t j = 0; j <= last; ++j)
      cnt += (p.sk[srow + min(lo + j, ns - 1)] <= q);
    seg = lo + max(cnt - 1, 0);
  } else {
    for (int32_t t = 0; t < p.search_trips; ++t) {
      const int32_t mid = (lo + hi + 1) >> 1;
      const bool go = p.sk[srow + min(mid, ns - 1)] <= q;
      lo = go ? mid : lo;
      hi = go ? hi : mid - 1;
    }
    seg = lo;
  }

  // 4. float32 interpolation at the clipped segment (min(max(.)) order)
  const int64_t g = srow + min(max(seg, 0), ns - 2);
  const int64_t x0 = p.sk[g];
  const int64_t x1 = p.sk[g + 1];
  const float y0 = p.spos[g];
  const float y1 = p.spos[g + 1];
  const float dx = fmaxf(u64_to_f32_pair(key_diff(x1, x0)), 1.0f);
  const float dq = (q < x0) ? 0.0f : u64_to_f32_pair(key_diff(q, x0));
  const float tt = fminf(fmaxf(__fdiv_rn(dq, dx), 0.0f), 1.0f);
  const float pred = __fadd_rn(y0, __fmul_rn(tt, __fsub_rn(y1, y0)));
  int32_t base = static_cast<int32_t>(floorf(pred)) - p.eps_eff;
  base = min(max(base, 0), static_cast<int32_t>(p.n_data_max - p.window));

  // 5. eps-window probe: first index in [base, base + window] with key >= q
  const int64_t drow = static_cast<int64_t>(s) * p.n_data_max;
  int64_t got;
  if (!PROBE_BISECT) {
    const int64_t* w = p.dk + drow + base;
    int32_t c = 0;
    for (int32_t j = 0; j < p.window; ++j) c += (w[j] < q);
    got = base + c;
  } else {
    int64_t plo = drow + base;
    int64_t phi = drow + base + p.window - 1;
    for (int32_t t = 0; t < p.probe_trips; ++t) {
      const int64_t mid = (plo + phi) >> 1;
      const bool ge = !(p.dk[mid] < q);
      phi = ge ? mid : phi;
      plo = ge ? plo : mid + 1;
    }
    got = plo - drow;
  }

  // 6. clamp to the shard's real keys, add its global row offset
  const int64_t nr = __ldg(p.n_real + s);
  int32_t res = static_cast<int32_t>(got < nr ? got : nr) + __ldg(p.row_off + s);

  // 7. merged lookup: + cum0[# delta keys < q]
  if (FOLD) {
    int32_t dlo = 0, dhi = p.cap - 1;
    for (int32_t t = 0; t < p.delta_trips; ++t) {
      const int32_t mid = (dlo + dhi) >> 1;
      const bool ge = !(__ldg(p.dkeys + mid) < q);
      dhi = ge ? mid : dhi;
      dlo = ge ? dlo : mid + 1;
    }
    res += __ldg(p.dcum + dlo);
  }

  p.out[i] = res;
  if (p.sid_out) p.sid_out[i] = s;
  if (p.base_out) p.base_out[i] = base;
}

template <int KIND, bool SB, bool PB, bool FOLD>
static void launch(const PlexParams& p, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (p.n_q + kThreads - 1) / kThreads;
  stacked_lookup_kernel<KIND, SB, PB, FOLD>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
}

template <int KIND, bool SB, bool PB>
static void pick_fold(const PlexParams& p, int fold, cudaStream_t st) {
  if (fold) launch<KIND, SB, PB, true>(p, st);
  else launch<KIND, SB, PB, false>(p, st);
}

template <int KIND, bool SB>
static void pick_probe(const PlexParams& p, int probe_bisect, int fold, cudaStream_t st) {
  if (probe_bisect) pick_fold<KIND, SB, true>(p, fold, st);
  else pick_fold<KIND, SB, false>(p, fold, st);
}

template <int KIND>
static void pick_spline(const PlexParams& p, int spline_bisect, int probe_bisect,
                        int fold, cudaStream_t st) {
  if (spline_bisect) pick_probe<KIND, true>(p, probe_bisect, fold, st);
  else pick_probe<KIND, false>(p, probe_bisect, fold, st);
}

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted.
int plex_stacked_lookup(const PlexParams* p, int cht, int spline_bisect,
                        int probe_bisect, int fold, void* stream) {
  if (p->n_q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cht) pick_spline<kCht>(*p, spline_bisect, probe_bisect, fold, st);
  else pick_spline<kRadix>(*p, spline_bisect, probe_bisect, fold, st);
  return static_cast<int>(cudaGetLastError());
}

const char* plex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int plex_params_size() { return static_cast<int>(sizeof(PlexParams)); }

}  // extern "C"
