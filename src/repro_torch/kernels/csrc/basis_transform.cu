// Two-sided basis transform over a client stack: out[i] = (A . g[i]) . B.
//
// Replaces src/repro/kernels/basis_transform.py::basis_transform (the
// Pallas kernel `_transform_kernel`), associated the same way: the (rows,
// d2) product A . g[i] is formed first and then multiplied by B.  float32
// throughout with fused multiply-adds on the CUDA cores (no TF32).  Each
// dot product is summed in chunks of kChunk terms (FMAs within a chunk,
// the chunk sums added in order).  One running sum over d = 1024 terms
// leaves an error close to the contract of 1e-6 of the largest output;
// the chunked sum stays well inside it (chip_smoke.py measures the error
// at d = 1024).
//
// Layout: grid (ceil(da / kRows), n).  A block owns kRows rows of A and one
// client.  It stages those rows of A in shared memory, then each thread
// takes columns c of g[i] and accumulates the kRows entries of row-block
// (A . g[i])[:, c] in registers, reading g[i][:, c] once from global memory
// (neighbouring threads read neighbouring columns).  The (kRows, d2) result
// stays in shared memory and is multiplied by B the same way, so the
// intermediate never goes to device memory.  Shared memory holds
// kRows * (d1 + d2) floats; larger shapes are refused by the wrapper.
//
// Bound on an H100: 2 n (da d1 d2 + da d2 db) float32 operations at
// 67 TFLOP/s against the bytes of A, g, B and out at 3.35 TB/s.  At the
// BL-DNN path's shapes (d1, d2 <= 96, n = 8) both are under a microsecond
// and a call costs its launch latency.  At large shapes this simple design
// re-reads g[i] and B once per row block (from L2) and loads A from shared
// memory for every FMA; a wgmma / TMA pipeline is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;
constexpr int kChunk = 32;

// out[r] = sum over l < len of rows[r * stride + l] * col[l * ld], for the
// kRows rows, summed in chunks of kChunk.
__device__ __forceinline__ void dot_rows(const float* rows, int stride, const float* col,
                                         int ld, int len, float (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.0f;
  for (int l0 = 0; l0 < len; l0 += kChunk) {
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
    const int l1 = min(l0 + kChunk, len);
    for (int l = l0; l < l1; ++l) {
      const float x = col[static_cast<size_t>(l) * ld];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = fmaf(rows[r * stride + l], x, part[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r] += part[r];
  }
}

__global__ void __launch_bounds__(kThreads)
basis_transform_kernel(const float* __restrict__ A, const float* __restrict__ g,
                       const float* __restrict__ B, float* __restrict__ out, int da,
                       int d1, int d2, int db) {
  extern __shared__ float smem[];
  float* As = smem;               // (kRows, d1) rows of A
  float* Ts = smem + kRows * d1;  // (kRows, d2) rows of A . g[i]

  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, da - r0);
  const float* gi = g + static_cast<size_t>(blockIdx.y) * d1 * d2;
  float* oi = out + static_cast<size_t>(blockIdx.y) * da * db;

  for (int idx = threadIdx.x; idx < kRows * d1; idx += kThreads) {
    const int r = idx / d1;
    As[idx] = r < rows ? A[static_cast<size_t>(r0 + r) * d1 + idx % d1] : 0.0f;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < d2; c += kThreads) {
    float acc[kRows];
    dot_rows(As, d1, gi + c, d2, d1, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) Ts[r * d2 + c] = acc[r];
  }
  __syncthreads();

  for (int c = threadIdx.x; c < db; c += kThreads) {
    float acc[kRows];
    dot_rows(Ts, d2, B + c, db, d2, acc);
    for (int r = 0; r < rows; ++r) oi[static_cast<size_t>(r0 + r) * db + c] = acc[r];
  }
}

}  // namespace

// Shared memory one block needs for (d1, d2), in bytes.
extern "C" long long basis_transform_smem_bytes(int d1, int d2) {
  return static_cast<long long>(kRows) * (d1 + d2) * static_cast<long long>(sizeof(float));
}

// A: (da, d1), g: (n, d1, d2), B: (d2, db), out: (n, da, db); float32,
// contiguous.  Returns cudaGetLastError() after the launch (or the error of
// the shared-memory opt-in).
extern "C" int basis_transform_f32(const void* A, const void* g, const void* B, void* out,
                                   int n, int da, int d1, int d2, int db, void* stream) {
  if (n == 0 || da == 0 || db == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(basis_transform_smem_bytes(d1, d2));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        basis_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((da + kRows - 1) / kRows, n);
  basis_transform_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(g),
      static_cast<const float*>(B), static_cast<float*>(out), da, d1, d2, db);
  return static_cast<int>(cudaGetLastError());
}
