// Exact per-row k-th largest of non-negative float32 values.
//
// Replaces src/repro/kernels/topk_threshold.py::topk_row_threshold (the
// Pallas kernel `_threshold_kernel`).  Same algorithm, so the same answer
// bit for bit: a 31-pass binary search over the int32 bit patterns
// (topk_select.cuh).
//
// Layout: one block per row.  Each thread counts its strided share of the
// row against the candidate, a warp sums with __reduce_add_sync, and the
// block sums the warp partials through shared memory; every thread then
// updates t identically, so no broadcast is needed (topk_select.cuh, shared
// with the fused compress-sum kernel).  Rows that fit are staged in shared
// memory once (`staged`); longer rows are re-read from global memory
// (served from L2) on each pass.
//
// Bound on an H100: at the main path's shapes (10 x 576 and 512 x 1024
// floats) the work is one read of rows*T*4 bytes plus 31*rows*T integer
// compares, both well under launch latency, so a launch costs about its
// latency.  A radix select (4 passes of 8 bits instead of 31 of 1) is later
// work.

#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

__global__ void __launch_bounds__(topk::kThreads)
topk_row_threshold_kernel(const float* __restrict__ a, float* __restrict__ out,
                          int T, int k, int staged) {
  extern __shared__ int row_keys[];
  __shared__ unsigned warp_count[topk::kWarps];

  const int* g = reinterpret_cast<const int*>(a) + static_cast<size_t>(blockIdx.x) * T;
  const int* keys = g;
  if (staged) {
    for (int i = threadIdx.x; i < T; i += topk::kThreads) row_keys[i] = g[i];
    __syncthreads();
    keys = row_keys;
  }
  const int t = topk::row_threshold(topk::PlainKeys{keys}, T, k, warp_count);
  if (threadIdx.x == 0) out[blockIdx.x] = __int_as_float(t);
}

}  // namespace

// a: (rows, T) float32, contiguous, values >= 0; out: (rows,) float32.
// k must already be clamped to [1, T].  Stages each row in shared memory
// when T * 4 bytes fit in `smem_limit`.  Returns cudaGetLastError() after
// the launch.
extern "C" int topk_row_threshold_f32(const void* a, void* out, int rows, int T,
                                      int k, int smem_limit, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const size_t row_bytes = static_cast<size_t>(T) * sizeof(int);
  const int staged = row_bytes <= static_cast<size_t>(smem_limit) ? 1 : 0;
  topk_row_threshold_kernel<<<rows, topk::kThreads, staged ? row_bytes : 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), T, k, staged);
  return static_cast<int>(cudaGetLastError());
}
