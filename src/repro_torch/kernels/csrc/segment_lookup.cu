// Single-index PLEX segment lookup for Hopper (sm_90a): K2 (radix layer)
// and K3 (CHT layer), one thread per query, alone or fused with K4.
//
// Replaces the TPU kernels repro/kernels/plex_segment_lookup.py::
// radix_segment_lookup (body radix_window_base) and cht_segment_lookup
// (body cht_window_base). One departure: the radix prefix saturates at the
// last bucket where the reference keeps the low 32 bits of the shifted
// difference, which misroutes a key far past the last one (ROADMAP queue
// 3, R5); where (q - min) >> shift < 2^31, as for every key up to the
// last, the two prefixes are equal. Per query: radix-table window or CHT
// descent over the spline points -> spline predecessor -> float32
// interpolation -> window base clip(floor(pred) - eps_eff, 0,
// n_data - window), the first index of the eps window that
// bounded_search.cu (K4) probes.
//
// The reference computes the CHT's per-level bins outside its kernel as an
// int32 [levels, B] plane; here they come from the query key inside the
// kernel (cht_descend), so no bins plane is materialised.
//
// What bounds it: scattered reads into the small planes, each a 32-byte
// sector request of its own (neighbouring threads hold unrelated keys):
// the table pair or `levels` CHT cells, the predecessor search over the
// window's spline keys, the segment's two keys and ranks. At 2^24 keys the
// planes are 44 KB-0.8 MB and stay in L1 or L2; on an NVIDIA H100 80GB
// HBM3 at 700 W one such read a query costs about as much as streaming the
// 12 bytes a query in and out (tools/segment_split.py, PERF.md), so the
// time follows the number of reads a query makes. The reference's search
// forms follow the TPU's rule (count up to 512 points,
// planes.COUNT_MODE_MAX): on this card the count reads every key of the
// window, one load each, and a warp waits for its widest window.
//
// What the design does about it:
// - the card's default search form is the adaptive one (kAdaptive in
//   plex_device.cuh): bisect rounds only while the query's window holds
//   more than one point, and the keys it probed at the predecessor and
//   after it serve the interpolation, which then reads only the two ranks.
//   Measured the fastest of the three forms at every window width, 3 to 354
//   points; count and bisect stay selectable (FORM, a compile-time switch);
// - the small planes are read with an L2 evict_last policy and the queries
//   streamed in and the bases out evict-first, so the data segments that
//   the fused form streams do not push the planes out of L2;
// - the fused form (PROBE 1 or 2) runs K4's summary probe on the base in
//   registers: one launch a lookup, and neither the base (4 B written, 4 B
//   read) nor the query key (8 B) makes a second trip through DRAM.
//   Measured faster than the two launches on each SOSD dataset, so
//   DevicePlex.lookup takes it.
// Candidates measured and left out (tools/segment_split.cu): a bisect to
// one 8-key segment counted with 16-byte loads, two queries a thread, 8
// lanes a query, the CHT's level 0 in shared memory.

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
  int32_t* out;           // window bases; fused: first indices >= q
  const int64_t* dk;      // fused only: the data plane and its summary
  const int64_t* s1;
  const int64_t* s2;
  int64_t n_q;
  int64_t min_key;        // radix: biased first spline key
  int64_t n_row;          // fused: keys in dk
  int64_t n1;             // fused: level-1 summary samples
  int32_t n_spline;
  int32_t eps_eff;
  int32_t base_max;       // n_data - window
  int32_t shift;          // radix
  int32_t p_max;          // radix: 2^r - 1
  int32_t search_width;   // count: max_win (radix) or delta + 1 (CHT)
  int32_t search_trips;   // bisect: bit_length(max_win - 1) or bit_length(delta)
  int32_t r;              // CHT radix bits
  int32_t levels;         // CHT levels
  int32_t delta;          // CHT window width - 1
  int32_t window;         // fused: the eps window K4 probes
};

enum { kRadix = 0, kCht = 1 };

// PROBE 0: write the window base (K2/K3); 1, 2: run K4's summary probe over
// that many levels on it and write the first index >= q (the fused form).
template <int KIND, int FORM, int PROBE>
__global__ void __launch_bounds__(256)
segment_lookup_kernel(const SegParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_q) return;
  const uint64_t pol = summary_policy();
  const KeptLoad ld{pol};
  const int64_t q = __ldcs(reinterpret_cast<const long long*>(p.q) + i);
  int32_t lo, hi;
  if (KIND == kRadix) {
    radix_window(ld, p.table, q, p.min_key, p.shift, p.p_max, lo, hi);
  } else {
    lo = cht_descend(ld, p.cells, q, p.r, p.levels);
    hi = min(lo + p.delta, p.n_spline - 1);
  }
  int32_t base;
  if constexpr (FORM == kAdaptive) {
    base = segment_base(ld, p.sk, p.spos, p.n_spline, q,
                        adaptive_predecessor(ld, p.sk, p.n_spline, q, lo, hi),
                        p.eps_eff, p.base_max);
  } else {
    base = segment_base(ld, p.sk, p.spos, p.n_spline, q,
                        spline_predecessor<FORM>(ld, p.sk, p.n_spline, q, lo,
                                                 hi, p.search_width,
                                                 p.search_trips),
                        p.eps_eff, p.base_max);
  }
  if constexpr (PROBE == 0) {
    __stcs(p.out + i, base);
  } else {
    __stcs(p.out + i, static_cast<int32_t>(summary_lower_bound<PROBE>(
                          p.dk, p.s1, p.s2, p.n_row, p.n1, q, base, p.window,
                          pol)));
  }
}

template <int KIND, int FORM, int PROBE>
static void launch(const SegParams& p, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (p.n_q + kThreads - 1) / kThreads;
  segment_lookup_kernel<KIND, FORM, PROBE>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
}

template <int KIND, int FORM>
static void pick_probe(const SegParams& p, int probe, cudaStream_t st) {
  if (probe == 1) launch<KIND, FORM, 1>(p, st);
  else if (probe == 2) launch<KIND, FORM, 2>(p, st);
  else launch<KIND, FORM, 0>(p, st);
}

template <int KIND>
static void pick_form(const SegParams& p, int form, int probe,
                      cudaStream_t st) {
  if (form == kBisect) pick_probe<KIND, kBisect>(p, probe, st);
  else if (form == kAdaptive) pick_probe<KIND, kAdaptive>(p, probe, st);
  else pick_probe<KIND, kCount>(p, probe, st);
}

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted. `form`: 0
// count, 1 bisect, 2 adaptive; `probe`: 0 the window base alone, 1 or 2 the
// fused summary probe over that many levels.
int plex_segment_lookup(const SegParams* p, int cht, int form, int probe,
                        void* stream) {
  if (p->n_q <= 0) return 0;
  if (form < 0 || form > 2 || probe < 0 || probe > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cht) pick_form<kCht>(*p, form, probe, st);
  else pick_form<kRadix>(*p, form, probe, st);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int segment_params_size() { return static_cast<int>(sizeof(SegParams)); }

}  // extern "C"
