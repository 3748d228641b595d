// Exact per-row k-th largest of non-negative float32 values.
//
// Replaces src/repro/kernels/topk_threshold.py::topk_row_threshold (the
// Pallas kernel `_threshold_kernel`, a 31-pass binary search over the int32
// bit patterns).  The answer is the same exact k-th largest key, bit for
// bit, found here by the four-pass radix select of topk_select.cuh.
//
// Layout: one 256-thread block per row, the row reaching it as the
// wrapper's `stage` says (topk_select.cuh): runs of up to 17 keys a thread
// loaded straight into registers (rows of up to 17 * 256 keys), the row
// staged in shared memory, or a row too long for that re-read from global
// memory on every pass.
//
// Bound on an H100: at the main path's shapes (10 x 576, 512 x 1024 and
// BL-DNN's 8 x <= 3072 floats) the work is one read of rows*T*4 bytes and a
// few integer operations a key a pass, both far under a launch's latency.
// What a launch costs is its serial chain: a global load, then per pass the
// histogram's shared atomics and two block barriers.

#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

// N > 0: runs of up to N keys in registers; N == 0: the row staged in
// shared memory.
template <int N>
__global__ void __launch_bounds__(topk::kThreads)
threshold_rows(const float* __restrict__ a, float* __restrict__ out, int T, int k, int run) {
  extern __shared__ __align__(16) float row[];
  __shared__ topk::Scratch scratch;
  const float* g = a + static_cast<size_t>(blockIdx.x) * T;
  topk::Selection sel;
  if constexpr (N > 0) {
    sel = topk::radix_select(topk::RegisterRun<N, topk::PlainKey>(g, T, run), k, scratch);
  } else {
    topk::stage_row(row, g, T);
    sel = topk::radix_select(topk::SharedRun<topk::PlainKey>(row, T, run), k, scratch);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = __int_as_float(sel.t);
}

__global__ void __launch_bounds__(topk::kThreads)
threshold_global(const float* __restrict__ a, float* __restrict__ out, int T, int k) {
  __shared__ topk::Scratch scratch;
  const int* g = reinterpret_cast<const int*>(a) + static_cast<size_t>(blockIdx.x) * T;
  const topk::Selection sel =
      topk::radix_select(topk::StridedKeys<topk::PlainKey>{g, T}, k, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = __int_as_float(sel.t);
}

template <int N>
cudaError_t launch_rows(const float* a, float* out, int rows, int T, int k, int run,
                        size_t smem, cudaStream_t s) {
  if (smem + sizeof(topk::Scratch) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        threshold_rows<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  threshold_rows<N><<<rows, topk::kThreads, smem, s>>>(a, out, T, k, run);
  return cudaGetLastError();
}

}  // namespace

// a: (rows, T) float32, contiguous, values >= 0; out: (rows,) float32.
// k must already be clamped to [1, T].  `stage` and `run` (the wrapper's
// choice; topk_select.cuh): how a row reaches its block, and the keys a
// thread owns of a row that is not kGlobal.  Returns cudaErrorInvalidValue
// for a form it cannot run, else cudaGetLastError() after the launch.
extern "C" int topk_row_threshold_f32(const void* a, void* out, int rows, int T, int k,
                                      int stage, int run, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (!topk::form_ok(stage, run, T)) return static_cast<int>(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(a);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == topk::kGlobal) {
    threshold_global<<<rows, topk::kThreads, 0, s>>>(in, o, T, k);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = stage == topk::kShared ? static_cast<size_t>(T) * sizeof(float) : 0;
  cudaError_t e;
  TOPK_DISPATCH_ROW(stage, run, launch_rows, in, o, rows, T, k, run, smem, s)
  return static_cast<int>(e);
}
