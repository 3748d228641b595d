// Exact per-row k-th largest of non-negative float32 values.
//
// Replaces src/repro/kernels/topk_threshold.py::topk_row_threshold (the
// Pallas kernel `_threshold_kernel`).  Same algorithm, so the same answer
// bit for bit: the IEEE-754 pattern of a non-negative float is monotone in
// its value, so the search runs on int32 keys.  31 count passes, one per
// non-sign bit from bit 30 down, greedily build the largest key t with
// count(key >= t) >= k, which is exactly the k-th largest value, ties
// included.  Counts are integers, so the result is exact.
//
// Layout: one block per row.  Each thread counts its strided share of the
// row against the candidate, a warp sums with __reduce_add_sync, and the
// block sums the warp partials through shared memory; every thread then
// updates t identically, so no broadcast is needed.  Rows that fit are
// staged in shared memory once (`staged`); longer rows are re-read from
// global memory (served from L2) on each pass.
//
// Bound on an H100: at the main path's shapes (10 x 576 and 512 x 1024
// floats) the work is one read of rows*T*4 bytes plus 31*rows*T integer
// compares, both well under launch latency, so a launch costs about its
// latency.  A radix select (4 passes of 8 bits instead of 31 of 1) and a
// fused keep-mask epilogue are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
topk_row_threshold_kernel(const float* __restrict__ a, float* __restrict__ out,
                          int T, int k, int staged) {
  extern __shared__ int row_keys[];
  __shared__ unsigned warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* g = reinterpret_cast<const int*>(a) + static_cast<size_t>(blockIdx.x) * T;

  const int* keys = g;
  if (staged) {
    for (int i = tid; i < T; i += kThreads) row_keys[i] = g[i];
    __syncthreads();
    keys = row_keys;
  }

  int t = 0;
  for (int bit = 30; bit >= 0; --bit) {
    const int cand = t | (1 << bit);
    unsigned c = 0;
    for (int i = tid; i < T; i += kThreads) c += keys[i] >= cand ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) warp_count[warp] = c;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_count[w];
    __syncthreads();  // every thread has read warp_count before the next pass writes it
    if (total >= static_cast<unsigned>(k)) t = cand;
  }
  if (tid == 0) out[blockIdx.x] = __int_as_float(t);
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
  topk_row_threshold_kernel<<<rows, kThreads, staged ? row_bytes : 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), T, k, staged);
  return static_cast<int>(cudaGetLastError());
}
