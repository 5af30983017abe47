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
// Bit-exactness with the reference: the device functions of plex_device.cuh
// (shared with K2-K4) round the interpolation exactly as the reference does.

#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

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
    table_window(p.table + __ldg(p.table_off + s),
                 radix_prefix_wrapped(q, __ldg(p.lmin + s), __ldg(p.shift + s),
                                      __ldg(p.p_max + s)),
                 lo, hi);
  } else {
    lo = cht_descend(p.cells + __ldg(p.cells_off + s), q, p.r, p.levels);
    hi = min(lo + __ldg(p.delta + s), ns - 1);
  }

  // 3. spline predecessor: largest i in [lo, hi] with sk[i] <= q
  const int32_t seg = spline_predecessor<SPLINE_BISECT>(
      p.sk + srow, ns, q, lo, hi, p.search_width, p.search_trips);

  // 4. float32 interpolation -> window base
  const int32_t base = segment_base(p.sk + srow, p.spos + srow, ns, q, seg,
                                    p.eps_eff,
                                    static_cast<int32_t>(p.n_data_max - p.window));

  // 5. eps-window probe: first index in [base, base + window] with key >= q
  const int64_t drow = static_cast<int64_t>(s) * p.n_data_max;
  const int64_t got = window_lower_bound<PROBE_BISECT>(
      p.dk + drow, q, base, p.window, p.probe_trips);

  // 6. clamp to the shard's real keys, add its global row offset
  const int64_t nr = __ldg(p.n_real + s);
  int32_t res = static_cast<int32_t>(got < nr ? got : nr) + __ldg(p.row_off + s);

  // 7. merged lookup: + cum0[# delta keys < q]
  if (FOLD)
    res += __ldg(p.dcum + window_lower_bound<true>(p.dkeys, q, 0, p.cap,
                                                    p.delta_trips));

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
