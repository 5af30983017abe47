// Single-index PLEX segment lookup for Hopper (sm_90a): K2 (radix layer)
// and K3 (CHT layer), one thread per query.
//
// Replaces the TPU kernels repro/kernels/plex_segment_lookup.py::
// radix_segment_lookup (body radix_window_base) and cht_segment_lookup
// (body cht_window_base). One departure: the radix prefix saturates at the
// last bucket where the reference keeps the low 32 bits of the shifted
// difference, which misroutes a key far past the last one (ROADMAP queue
// 3, R5); where (q - min) >> shift < 2^31, as for every key up to the
// last, the two prefixes are equal. Per query: radix-table
// window or CHT descent over
// the spline points -> spline predecessor (count or bisect, a compile-time
// switch) -> float32 interpolation -> window base
// clip(floor(pred) - eps_eff, 0, n_data - window), the first index of the
// eps window that bounded_search.cu (K4) probes.
//
// The reference computes the CHT's per-level bins outside its kernel as an
// int32 [levels, B] plane; here they come from the query key inside the
// kernel (cht_descend), so no bins plane is materialised.
//
// What bounds it: bytes gathered per query. Each query reads its 8-byte key
// and writes a 4-byte base; in between it gathers a table entry pair or a
// few CHT cells (small planes, L2-resident), a handful of spline keys
// (bisect: bit_length(window) of them; count: up to the window) and the two
// spline keys and ranks of its segment. The gathers are dependent and
// uncoalesced (neighbouring threads hold unrelated keys), so the kernel is
// latency-bound; the arithmetic is a few dozen integer ops and five float
// ops a query. The design answers with occupancy: one thread per query, no
// shared state, small planes read through the read-only path, and the
// spline plane (16 B a point, N / eps-ish points) largely L2-resident.

#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

struct SegParams {
  // field order mirrors _SegParams in segment_lookup.py
  const int64_t* q;
  const int64_t* sk;
  const float* spos;
  const int32_t* table;   // radix only
  const uint32_t* cells;  // CHT only
  int32_t* out;
  int64_t n_q;
  int64_t min_key;        // radix: biased first spline key
  int32_t n_spline;
  int32_t eps_eff;
  int32_t base_max;       // n_data - window
  int32_t shift;          // radix
  int32_t p_max;          // radix: 2^r - 1
  int32_t search_width;   // count mode: max_win (radix) or delta + 1 (CHT)
  int32_t search_trips;   // bisect: bit_length(max_win - 1) or bit_length(delta)
  int32_t r;              // CHT radix bits
  int32_t levels;         // CHT levels
  int32_t delta;          // CHT window width - 1
};

enum { kRadix = 0, kCht = 1 };

template <int KIND, bool SPLINE_BISECT>
__global__ void __launch_bounds__(256)
segment_lookup_kernel(const SegParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_q) return;
  const int64_t q = p.q[i];
  int32_t lo, hi;
  if (KIND == kRadix) {
    table_window(p.table, radix_prefix(q, p.min_key, p.shift, p.p_max), lo,
                 hi);
  } else {
    lo = cht_descend(p.cells, q, p.r, p.levels);
    hi = min(lo + p.delta, p.n_spline - 1);
  }
  const int32_t seg = spline_predecessor<SPLINE_BISECT>(
      p.sk, p.n_spline, q, lo, hi, p.search_width, p.search_trips);
  p.out[i] = segment_base(p.sk, p.spos, p.n_spline, q, seg, p.eps_eff,
                          p.base_max);
}

template <int KIND, bool SB>
static void launch(const SegParams& p, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (p.n_q + kThreads - 1) / kThreads;
  segment_lookup_kernel<KIND, SB>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
}

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted.
int plex_segment_lookup(const SegParams* p, int cht, int spline_bisect,
                        void* stream) {
  if (p->n_q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cht) {
    if (spline_bisect) launch<kCht, true>(*p, st);
    else launch<kCht, false>(*p, st);
  } else {
    if (spline_bisect) launch<kRadix, true>(*p, st);
    else launch<kRadix, false>(*p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int segment_params_size() { return static_cast<int>(sizeof(SegParams)); }

}  // extern "C"
