// Eps-window data probe for Hopper (sm_90a): K4, one thread per query.
//
// Replaces the TPU kernel repro/kernels/bounded_search.py::bounded_search:
// out = base + |{j < window : data[base + j] < q}|, exact because the window
// contains the lower bound (the eps guarantee) and the data is sorted.
// The reference gathers a [B, W] window of data keys in XLA and hands the
// tiles to its kernel; at 2^20 queries and W = 256 that gather would
// materialise 2 GiB, so here the kernel reads the data plane itself and
// nothing is gathered ahead. Two numerically identical forms, a compile-time
// switch: a count over the window (W keys a query), or the summary probe of
// plex_device.cuh as the bisect form.
//
// What bounds it: bytes. A query reads its 8-byte key and 4-byte base and
// writes a 4-byte index; the data plane (134 MB at 2^24 keys, beyond the
// 50 MB L2) costs at least the sector holding the answer. The reference's
// bisect (bit_length(W) = 9 dependent reads in a 2 KB window) touched six or
// seven distinct 32-byte sectors of it a query, and neighbouring threads
// hold unrelated keys, so each is its own DRAM transaction: 0.153 ms at
// 2^20 queries, 11x the bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// What the design does about it: the summary probe bisects the window's
// samples of the data plane's key summary (every 8th key, 16.8 MB at 2^24
// keys), which the L2 evict_last policy keeps in L2, and then reads the one
// 64-byte segment of the data plane that holds the answer, as four 16-byte
// evict-first loads: 80 bytes of DRAM a query in all. Where the index is too
// large for a one-level summary to stay in L2 (planes.summary_levels), it
// bisects every 64th key first and reads one 64-byte segment of the
// 8th-key level before the data segment. One thread per query with no
// shared state keeps as many queries in flight as occupancy allows.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, 2^20 queries, window 256
// (PERF.md): over 2^24 keys 0.069 ms, against 0.153 ms for the reference's
// bisect and 0.176 ms for torch.searchsorted; one random 8-byte read at
// each answer alone takes 0.036 ms, the level-1 bisect alone 0.044 ms and
// the data segment alone 0.038-0.043 ms, so L2 traffic and scattered DRAM
// reads now share the time. Over the service's 200M keys (a 200 MB
// level 1) one level takes 0.121 ms and two 0.087 ms.

#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

struct ProbeParams {
  // field order mirrors _ProbeParams in bounded_search.py
  const int64_t* dk;
  const int64_t* s1;  // summary level 1: every 8th key of dk
  const int64_t* s2;  // summary level 2: every 64th key of dk
  const int64_t* q;
  const int32_t* base;
  int32_t* out;
  int64_t n_q;
  int64_t n_row;  // keys in dk (one row)
  int64_t n1;     // level-1 samples
  int32_t window;
};

// FORM 0: the count over the window; 1, 2: the summary probe, that many
// levels.
template <int FORM>
__global__ void __launch_bounds__(256)
bounded_search_kernel(const ProbeParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_q) return;
  const int64_t q = __ldcs(reinterpret_cast<const long long*>(p.q) + i);
  const int64_t base = __ldcs(p.base + i);
  int64_t got;
  if (FORM == 0) {
    got = window_lower_bound<false>(p.dk, q, base, p.window, 0);
  } else {
    got = summary_lower_bound<FORM>(p.dk, p.s1, p.s2, p.n_row, p.n1, q, base,
                                    p.window, summary_policy());
  }
  __stcs(p.out + i, static_cast<int32_t>(got));
}

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted.
int plex_bounded_search(const ProbeParams* p, int form, void* stream) {
  if (p->n_q <= 0) return 0;
  if (form < 0 || form > 2) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((p->n_q + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) bounded_search_kernel<0><<<blocks, kThreads, 0, st>>>(*p);
  else if (form == 1) bounded_search_kernel<1><<<blocks, kThreads, 0, st>>>(*p);
  else bounded_search_kernel<2><<<blocks, kThreads, 0, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

const char* bounded_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bounded_search_params_size() { return static_cast<int>(sizeof(ProbeParams)); }

}  // extern "C"
