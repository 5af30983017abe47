// Fused stacked PLEX lookup for Hopper (sm_90a): one thread per query.
//
// Replaces the TPU kernel repro/kernels/stacked_pallas.py::stacked_pallas_lookup
// (body _kernel_body -> jnp_lookup._stacked_pipeline + delta_rank_adjust).
// Per query: route to a shard -> radix-table or CHT window over the spline
// points -> spline predecessor (count or bisect) -> float32 interpolation ->
// eps-window probe of the data keys (count, or the summary probe as the
// bisect form) -> clamp to the shard's real key count + its global row
// offset -> (+ delta fold when FOLD). Two runtime options wrap it, the
// device half of repro/kernels/jnp_lookup.py's _stacked_cached and
// _stacked_counted (jnp glue around the Pallas kernel on the TPU, here inside
// the one launch, so a micro-batch stays one launch):
// - the hot-key cache (`cache` set): a direct-mapped table of snapshot ranks,
//   one 16-byte slot (biased key, rank; rank -1 empty) per hash of the key.
//   A lane that hits skips the pipeline; a lane that missed writes its key
//   and snapshot rank through to its slot (a hit's slot already holds them,
//   and a store on every lane made the hottest slots serialise: PERF.md);
//   the delta is folded in after the cache on every lane, so entries
//   outlive inserts and deletes and die with their snapshot. Each launch
//   adds its hits to one device scalar;
// - the counter plane (`counters` set): per-shard routed counts and the
//   log2 histogram of probe travel, gathered in shared memory by each block
//   and added to the plane with one atomic a non-zero bin.
// The two are never combined (the counted dispatch bypasses the cache, as
// the reference's does). Both are runtime branches on null pointers, not
// template flags: the 24 instantiations stay 24 (a template flag for them,
// which left the plain launches without their code, timed no faster:
// PERF.md).
//
// What bounds it: bytes gathered per query, and on the serving path the
// launches. Each query reads its own 8-byte key and writes a 4-byte rank,
// but in between it gathers from planes far larger than any cache: a few
// table or CHT cells, spline keys and ranks, and then the data probe. The
// reference's bisect probe read ~9 dependent keys in a 2 KB window, six or
// seven distinct DRAM sectors a query. And at 200M keys the service's mixed
// radix/CHT shards do not unify, so a request of 2^20 queries is 26 launches
// of ~40k queries, each about 15% of the card's thread slots and as long as
// its slowest query's chain of dependent gathers, one after the other:
// 0.316 ms a request, 24x its byte bound (NVIDIA H100 80GB HBM3, 700 W).
//
// What the design does about it:
// - the probe is plex_device.cuh's summary probe: a bisect over the shard
//   row's key-summary samples, kept in L2 by an evict_last policy, then one
//   64-byte evict-first segment of the data plane (with two summary levels,
//   where the index's summary outgrows L2, one 64-byte segment of the
//   8th-key level first);
// - programmatic dependent launch: every block runs
//   griddepcontrol.launch_dependents at entry, and a launch whose
//   predecessor on the stream is a K1 launch of the same dispatch is made
//   with cudaLaunchAttributeProgrammaticStreamSerialization, so its blocks
//   start while the previous launch's last queries are in flight. The
//   launches of a dispatch read only planes no launch writes and each writes
//   its own output, so nothing waits for data. Each thread ends with
//   griddepcontrol.wait (a no-op without a predecessor in flight), so a
//   launch completes only after the one it overlapped: whatever the stream
//   runs next still sees every launch before it complete;
// - one thread per query with no shared state, per-shard scalars through
//   the read-only path (__ldg); the shard-minima, geometry and table planes
//   are small and stay in L1/L2. The Pallas kernel loaded every plane as a
//   whole VMEM block; that was a TPU limit and is not carried over.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): a service
// request of 2^20 queries over 200M keys in 26 launches takes 0.106 ms
// (two summary levels; 0.238 ms without overlap, 0.120 ms with one level,
// 0.316 ms before this design); one launch of 2^20 queries over 16M keys
// in two shards 0.077 ms with a bisect spline search (0.145-0.155 before).
//
// Bit-exactness with the reference: the device functions of plex_device.cuh
// (shared with K2-K4) round the interpolation exactly as the reference does.
// One departure: the radix prefix saturates where the reference's wraps for a
// key far past the last one (radix_window; ROADMAP queue 3, R5).
//
// The cache and overlap. With the cache on, launch i + 1 of a dispatch reads
// slots launch i writes, so a cached launch runs griddepcontrol.wait before
// it probes its slot: an overlapped cached launch overlaps only its
// prologue (the query load and the hash). Results never depend on it (a
// slot only ever holds a key's own snapshot rank); hit counts do.
//
// Torn slots. Two lanes with different keys on one slot must never leave
// key A beside rank B. A slot is written with one 16-byte store and read
// with one 16-byte load (st/ld.global.cg.v2.s64, 16-byte aligned). The PTX
// memory model does not promise a vector access is single-copy atomic, so
// chip_smoke.py's tear stress (2^20 lanes over 64 keys of one slot, 100
// launches, every rank against np.searchsorted) is what holds it on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

constexpr int kProbeBuckets = 16;  // N_PROBE_BUCKETS of the reference

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
  const int64_t* s1;  // key summary level 1: every 8th key of each dk row
  const int64_t* s2;  // key summary level 2: every 64th key of each dk row
  int32_t* out;
  int32_t* sid_out;   // nullable: routed shard id per query
  int32_t* base_out;  // nullable: local eps-window base per query
  int64_t* cache;     // nullable: [slots][2] (biased key, snapshot rank)
  int32_t* hits;      // with cache: this launch's hits are added here
  unsigned long long* counters;  // nullable: [n_shards + kProbeBuckets]
  int64_t n_q;
  int64_t n_spline_max;
  int64_t n_data_max;
  int64_t n1;            // level-1 summary samples a row
  int64_t n2;            // level-2 summary samples a row
  int32_t n_shards;
  int32_t eps_eff;
  int32_t window;
  int32_t search_width;  // spline window the count mode covers
  int32_t search_trips;  // bisect trips over the spline window
  int32_t r;             // CHT radix bits
  int32_t levels;        // CHT levels (deepest shard)
  int32_t cap;           // delta capacity (FOLD only)
  int32_t delta_trips;   // bit_length(cap)
  int32_t cache_mask;    // cache slots - 1 (a power of two)
};

enum { kRadix = 0, kCht = 1 };

// Slot of a key: _cache_slot's 32-bit multiplicative mix of the unbiased
// key's two words.
__device__ __forceinline__ uint32_t cache_slot(int64_t qb, int32_t mask) {
  const uint64_t k = static_cast<uint64_t>(qb) ^ 0x8000000000000000ull;
  uint32_t h = (static_cast<uint32_t>(k) * 0x9E3779B1u) ^
               (static_cast<uint32_t>(k >> 32) * 0x85EBCA77u);
  h ^= h >> 16;
  return h & static_cast<uint32_t>(mask);
}

// _probe_bucket: 0 for a travel <= 0, else bit_length(travel) clipped to the
// last bucket. The reference takes floor(log2(travel)) + 1 in float32 with
// log2 as log(x) / log(2), which rounds 2^13 just below 13: that travel
// lands in bucket 13, not 14 (ROADMAP queue 3, R7), and so it does here.
__device__ __forceinline__ int probe_bucket(int64_t travel) {
  if (travel <= 0) return 0;
  if (travel == 8192) return 13;
  const int b = 64 - __clzll(travel);
  return b < kProbeBuckets - 1 ? b : kProbeBuckets - 1;
}

// Steps 1-6 for one query: its snapshot rank (clamped, global), with the
// routed shard, the window base and the probe's answer (row-local).
template <int KIND, bool SPLINE_BISECT, int PROBE>
__device__ __forceinline__ int32_t snapshot_rank(const PlexParams& p,
                                                 int64_t q, int32_t& s,
                                                 int32_t& base, int64_t& got) {
  // 1. route: #{shard minima <= q} - 1, clipped to [0, S - 1]
  s = 0;
  if (p.n_shards > 1) {
    int32_t cnt = 0;
    for (int32_t j = 0; j < p.n_shards; ++j) cnt += (__ldg(p.shard_min + j) <= q);
    s = min(max(cnt - 1, 0), p.n_shards - 1);
  }
  const int32_t ns = __ldg(p.n_spline + s);
  const int64_t srow = static_cast<int64_t>(s) * p.n_spline_max;

  // 2. window [lo, hi] of local spline indices
  const PlainLoad ld{};
  int32_t lo, hi;
  if (KIND == kRadix) {
    radix_window(ld, p.table + __ldg(p.table_off + s), q,
                 __ldg(p.lmin + s), __ldg(p.shift + s), __ldg(p.p_max + s),
                 lo, hi);
  } else {
    lo = cht_descend(ld, p.cells + __ldg(p.cells_off + s), q, p.r, p.levels);
    hi = min(lo + __ldg(p.delta + s), ns - 1);
  }

  // 3. spline predecessor: largest i in [lo, hi] with sk[i] <= q
  const int32_t seg = spline_predecessor<SPLINE_BISECT ? kBisect : kCount>(
      ld, p.sk + srow, ns, q, lo, hi, p.search_width, p.search_trips);

  // 4. float32 interpolation -> window base
  base = segment_base(ld, p.sk + srow, p.spos + srow, ns, q, seg, p.eps_eff,
                      static_cast<int32_t>(p.n_data_max - p.window));

  // 5. eps-window probe: first index in [base, base + window] with key >= q
  const int64_t* drow = p.dk + static_cast<int64_t>(s) * p.n_data_max;
  if (PROBE == 0) {
    got = window_lower_bound<false>(drow, q, base, p.window, 0);
  } else {
    got = summary_lower_bound<PROBE>(
        drow, p.s1 + static_cast<int64_t>(s) * p.n1,
        p.s2 + static_cast<int64_t>(s) * p.n2, p.n_data_max, p.n1, q, base,
        p.window, summary_policy());
  }

  // 6. clamp to the shard's real keys, add its global row offset
  const int64_t nr = __ldg(p.n_real + s);
  return static_cast<int32_t>(got < nr ? got : nr) + __ldg(p.row_off + s);
}

// PROBE 0: the count over the window; 1, 2: the summary probe, that many
// levels. The cache and the counters are runtime branches on null pointers
// (uniform across the grid), so they add no instantiation.
template <int KIND, bool SPLINE_BISECT, int PROBE, bool FOLD>
__global__ void __launch_bounds__(256)
stacked_lookup_kernel(const PlexParams p) {
  // the next launch of the dispatch may start its blocks now
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // counted launches: this block's [shards | probe buckets] histogram
  extern __shared__ unsigned int bins[];
  const int n_bins = p.n_shards + kProbeBuckets;
  if (p.counters) {
    for (int j = threadIdx.x; j < n_bins; j += blockDim.x) bins[j] = 0;
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool hit = false;
  if (i < p.n_q) {
    const int64_t q = __ldcs(reinterpret_cast<const long long*>(p.q) + i);
    int32_t res = 0;
    int64_t* slot = nullptr;
    if (p.cache) {
      slot = p.cache + 2 * static_cast<int64_t>(cache_slot(q, p.cache_mask));
      // the launch this one overlaps writes slots: wait for it first
      asm volatile("griddepcontrol.wait;" ::: "memory");
      long long key, rank;
      asm volatile("ld.global.cg.v2.s64 {%0, %1}, [%2];"
                   : "=l"(key), "=l"(rank) : "l"(slot) : "memory");
      hit = rank >= 0 && key == q;
      res = static_cast<int32_t>(rank);
    }
    if (!hit) {
      int32_t s, base;
      int64_t got;
      res = snapshot_rank<KIND, SPLINE_BISECT, PROBE>(p, q, s, base, got);
      if (p.counters) {
        atomicAdd(bins + s, 1u);
        atomicAdd(bins + p.n_shards + probe_bucket(got - base), 1u);
      }
      if (p.sid_out) p.sid_out[i] = s;
      if (p.base_out) p.base_out[i] = base;
    }
    if (p.cache && !hit)  // write-through: the key and its rank, one store
      asm volatile("st.global.cg.v2.s64 [%0], {%1, %2};"
                   :: "l"(slot), "l"(static_cast<long long>(q)),
                      "l"(static_cast<long long>(res)) : "memory");

    // 7. merged lookup: + cum0[# delta keys < q]
    if (FOLD)
      res += __ldg(p.dcum + window_lower_bound<true>(p.dkeys, q, 0, p.cap,
                                                      p.delta_trips));
    __stcs(p.out + i, res);
  }
  if (p.cache) {
    const int n_hit = __syncthreads_count(hit);
    if (threadIdx.x == 0 && n_hit) atomicAdd(p.hits, n_hit);
  }
  if (p.counters) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_bins; j += blockDim.x)
      if (bins[j]) atomicAdd(p.counters + j, static_cast<unsigned long long>(bins[j]));
  }
  // complete only after the launch this one overlapped (none: no wait)
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <int KIND, bool SB, int PROBE, bool FOLD>
static cudaError_t launch(const PlexParams& p, int overlap, cudaStream_t stream) {
  constexpr int kThreads = 256;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.n_q + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      p.counters ? sizeof(unsigned int) * (p.n_shards + kProbeBuckets) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, stacked_lookup_kernel<KIND, SB, PROBE, FOLD>, p);
}

template <int KIND, bool SB, int PROBE>
static cudaError_t pick_fold(const PlexParams& p, int fold, int overlap,
                             cudaStream_t st) {
  return fold ? launch<KIND, SB, PROBE, true>(p, overlap, st)
              : launch<KIND, SB, PROBE, false>(p, overlap, st);
}

template <int KIND, bool SB>
static cudaError_t pick_probe(const PlexParams& p, int probe, int fold,
                              int overlap, cudaStream_t st) {
  if (probe == 1) return pick_fold<KIND, SB, 1>(p, fold, overlap, st);
  if (probe == 2) return pick_fold<KIND, SB, 2>(p, fold, overlap, st);
  return pick_fold<KIND, SB, 0>(p, fold, overlap, st);
}

template <int KIND>
static cudaError_t pick_spline(const PlexParams& p, int spline_bisect, int probe,
                               int fold, int overlap, cudaStream_t st) {
  return spline_bisect ? pick_probe<KIND, true>(p, probe, fold, overlap, st)
                       : pick_probe<KIND, false>(p, probe, fold, overlap, st);
}

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns the launch's error, else cudaGetLastError() — 0 when the launch
// was accepted. `probe`: 0 the count form, 1 or 2 the summary probe over
// that many levels. `overlap`: the launch may start while its predecessor
// on the stream, a launch of the same dispatch, is still running.
int plex_stacked_lookup(const PlexParams* p, int cht, int spline_bisect,
                        int probe, int fold, int overlap, void* stream) {
  if (p->n_q <= 0) return 0;
  if (probe < 0 || probe > 2) return static_cast<int>(cudaErrorInvalidValue);
  // the block histogram lives in the default 48 KB of shared memory
  if (p->counters && p->n_shards + kProbeBuckets > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cht ? pick_spline<kCht>(*p, spline_bisect, probe, fold, overlap, st)
          : pick_spline<kRadix>(*p, spline_bisect, probe, fold, overlap, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* plex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int plex_params_size() { return static_cast<int>(sizeof(PlexParams)); }

}  // extern "C"
