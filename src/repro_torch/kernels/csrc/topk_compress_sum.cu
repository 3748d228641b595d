// Exact |.|-Top-K of every row of a float32 client stack, fused with the
// sum of the compressed rows over the client axis.
//
// Replaces src/repro/kernels/topk_threshold.py::topk_compress_sum (the
// Pallas kernel `_compress_sum_kernel`).  Contract: `dense` is bitwise the
// two-pass selection (threshold kernel + keep_mask + where), and `col_sum`
// is the sum of the dense rows taken in row order 0, 1, ..., n-1, so it is
// deterministic and bitwise equal to the plain version's row-order sum.
//
// Two kernels behind one entry point:
//
//   1. select_rows — one block per row.  The row's |v| keys are staged in
//      shared memory when they fit; the exact k-th largest key t comes from
//      the 31-pass search of topk_select.cuh.  A block sum counts the
//      entries strictly above t.  Then the block walks the row in tiles of
//      256 in index order; a warp ballot and the warp totals give each tie
//      (|v| == t) its in-order rank, carried across tiles, so the earliest
//      k - n_above ties are kept: the reference's tie-break.  Kept entries
//      are written as v, dropped ones as +0.
//   2. column_sums — one thread per column, summing the dense rows in row
//      order (no float atomics).
//
// Bound on an H100: one read of v and one write of dense (2*n*T*4 bytes)
// plus the T*4-byte sum, against 31 compare+add passes over n*T keys.  At
// the BL-DNN path's shapes ((8, 3072) and smaller) both are far below the
// launch latency, so a call costs about two launch latencies; one fused
// pass with a grid-wide row-order sum is later work.

#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

__global__ void __launch_bounds__(topk::kThreads)
select_rows(const float* __restrict__ v, float* __restrict__ dense, int T, int k,
            int staged) {
  extern __shared__ int row_keys[];
  __shared__ unsigned scratch[topk::kWarps];
  __shared__ unsigned warp_ties[topk::kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * T;
  const float* vr = v + row;
  float* out = dense + row;
  const int* g = reinterpret_cast<const int*>(vr);

  int t;
  if (staged) {
    for (int i = tid; i < T; i += topk::kThreads) row_keys[i] = g[i] & 0x7fffffff;
    __syncthreads();
    t = topk::row_threshold(topk::PlainKeys{row_keys}, T, k, scratch);
  } else {
    t = topk::row_threshold(topk::AbsKeys{g}, T, k, scratch);
  }
  const float tf = __int_as_float(t);

  unsigned above = 0;
  for (int i = tid; i < T; i += topk::kThreads) above += fabsf(vr[i]) > tf ? 1u : 0u;
  const unsigned n_above = topk::block_sum(above, scratch);
  const unsigned budget = static_cast<unsigned>(k) - n_above;  // ties to keep

  unsigned carry = 0;  // ties in earlier tiles
  for (int base = 0; base < T; base += topk::kThreads) {
    const int i = base + tid;
    float x = 0.0f;
    bool gt = false, eq = false;
    if (i < T) {
      x = vr[i];
      const float a = fabsf(x);
      gt = a > tf;
      eq = a == tf;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) warp_ties[warp] = __popc(ballot);
    __syncthreads();
    unsigned rank = carry + __popc(ballot & ((1u << lane) - 1u));  // ties before i
    unsigned tile = 0;
#pragma unroll
    for (int w = 0; w < topk::kWarps; ++w) {
      const unsigned c = warp_ties[w];
      rank += w < warp ? c : 0u;
      tile += c;
    }
    __syncthreads();  // warp_ties is rewritten by the next tile
    carry += tile;
    if (i < T) out[i] = (gt || (eq && rank + 1u <= budget)) ? x : 0.0f;
  }
}

__global__ void __launch_bounds__(topk::kThreads)
column_sums(const float* __restrict__ dense, float* __restrict__ col_sum, int n, int T) {
  const int c = blockIdx.x * topk::kThreads + threadIdx.x;
  if (c >= T) return;
  float s = 0.0f;
  for (int r = 0; r < n; ++r) s += dense[static_cast<size_t>(r) * T + c];
  col_sum[c] = s;
}

}  // namespace

// v: (n, T) float32, contiguous; dense: (n, T); col_sum: (T,).  k must
// already be clamped to [1, T].  Rows whose T * 4 bytes fit in `smem_limit`
// are staged in shared memory (above 48 KB by the opt-in attribute).
// Returns the first CUDA error of the two launches, else cudaSuccess.
extern "C" int topk_compress_sum_f32(const void* v, void* dense, void* col_sum, int n,
                                     int T, int k, int smem_limit, void* stream) {
  if (n == 0 || T == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = static_cast<size_t>(T) * sizeof(int);
  const int staged = row_bytes <= static_cast<size_t>(smem_limit) ? 1 : 0;
  const size_t smem = staged ? row_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  select_rows<<<n, topk::kThreads, smem, s>>>(static_cast<const float*>(v),
                                              static_cast<float*>(dense), T, k, staged);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  column_sums<<<(T + topk::kThreads - 1) / topk::kThreads, topk::kThreads, 0, s>>>(
      static_cast<const float*>(dense), static_cast<float*>(col_sum), n, T);
  return static_cast<int>(cudaGetLastError());
}
