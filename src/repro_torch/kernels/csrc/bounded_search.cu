// Eps-window data probe for Hopper (sm_90a): K4, one thread per query.
//
// Replaces the TPU kernel repro/kernels/bounded_search.py::bounded_search:
// out = base + |{j < window : data[base + j] < q}|, exact because the window
// contains the lower bound (the eps guarantee) and the data is sorted.
// The reference gathers a [B, W] window of data keys in XLA and hands the
// tiles to its kernel; at 2^20 queries and W = 256 that gather would
// materialise 2 GiB, so here the kernel reads the data plane at base + j
// itself and nothing is gathered ahead. Two numerically identical forms, a
// compile-time switch: a count over the window (W keys a query) or a
// fixed-trip bisect (bit_length(W) keys a query), as the reference's
// probe_lower_bound has them.
//
// What bounds it: bytes. A query reads its 8-byte key and 4-byte base and
// writes a 4-byte index; the data plane (134 MB at 2^24 keys, beyond the
// 50 MB L2) costs at least the one 32-byte sector holding the answer, and
// the count form reads a whole 2 KB window. Neighbouring threads hold
// unrelated keys, so every window read is its own uncoalesced gather; the
// bisect form's reads are dependent. One thread per query with no shared
// state keeps as many queries in flight as occupancy allows.

#include <cstdint>
#include <cuda_runtime.h>

#include "plex_device.cuh"

struct ProbeParams {
  // field order mirrors _ProbeParams in bounded_search.py
  const int64_t* dk;
  const int64_t* q;
  const int32_t* base;
  int32_t* out;
  int64_t n_q;
  int32_t window;
  int32_t trips;  // bit_length(window)
};

template <bool BISECT>
__global__ void __launch_bounds__(256)
bounded_search_kernel(const ProbeParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_q) return;
  p.out[i] = static_cast<int32_t>(window_lower_bound<BISECT>(
      p.dk, p.q[i], p.base[i], p.window, p.trips));
}

extern "C" {

// Launches one instantiation on `stream` (no sync, no allocation) and
// returns cudaGetLastError() — 0 when the launch was accepted.
int plex_bounded_search(const ProbeParams* p, int bisect, void* stream) {
  if (p->n_q <= 0) return 0;
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((p->n_q + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bisect) bounded_search_kernel<true><<<blocks, kThreads, 0, st>>>(*p);
  else bounded_search_kernel<false><<<blocks, kThreads, 0, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

const char* bounded_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bounded_search_params_size() { return static_cast<int>(sizeof(ProbeParams)); }

}  // extern "C"
