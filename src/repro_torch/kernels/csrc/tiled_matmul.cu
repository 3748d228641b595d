// Batched tiled matrix product C[b] = A[b] . B[b] with float32 accumulation.
//
// Replaces src/repro/kernels/tiled_matmul.py::matmul (the Pallas kernel
// `_matmul_kernel`): (bm x bk) . (bk x bn) tiles, every input converted to
// float32 as it is loaded, every sum kept in float32.  Here the products
// are float32 fused multiply-adds on the CUDA cores; no TF32 and no tensor
// cores, so each product is the full float32 one.  Inputs are float32,
// float64 or bfloat16 (each operand its own type), read in place through
// element strides: a transposed view or a batch broadcast (batch stride 0)
// needs no copy.  C is a contiguous (batch, M, N) float32 array.
//
// Layout: grid (ceil(N / kBN), ceil(M / kBM), batch).  A block owns one
// (kBM x kBN) tile of C of one batch entry and walks K in steps of kBK: it
// stages the (kBM x kBK) tile of A (transposed, k-major) and the (kBK x
// kBN) tile of B in shared memory as float32, then each of its 128 threads
// adds a 4 x 4 patch of C from a float4 of A and a float4 of B per k.
// Each tile's kBK products are summed into a fresh partial, in ascending k,
// and the partials are added to the running sum in order (chunked
// summation: at K = 1200 one running sum would sit near the 1e-5 contract
// against float64).  Ragged edges are bounds-checked and read as zeros,
// which gives the reference's zero padding without padded copies.  Offsets
// are 64-bit: A on the Newton-XL path is 512 x 1200 x 1200 float64, 5.9 GB.
//
// Bound on an H100: the Γ path's first product T = A_i V_i reads A once,
// 5.9 GB at fig1-xl's widths, about 1.8 ms at 3.35 TB/s, against 4.7e10
// operations, 0.70 ms at 67 TFLOP/s: bytes.  Each block reads its rows of A
// once (N = r <= kBN fits one column tile) and re-reads the small B tile
// from L2.  A TMA / wgmma pipeline is later work; the card's float32 path
// outside the tensor cores is what the contract allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 32;
constexpr int kBK = 32;
constexpr int kThreads = 128;         // 16 x 8 threads, a 4 x 4 patch each
constexpr int kTM = 4;
constexpr int kTN = 4;
// row strides of the staged tiles: +4 keeps float4 reads 16-byte aligned
// and spreads a k-major fill (a transposed operand) over 8 banks, not 1
constexpr int kAStride = kBM + 4;
constexpr int kBStride = kBN + 4;

enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
tiled_matmul_kernel(const TA* __restrict__ A, long long sAb, long long sAm, long long sAk,
                    const TB* __restrict__ B, long long sBb, long long sBk, long long sBn,
                    float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[kBK][kAStride];   // As[k][m] = A[m0 + m][k0 + k]
  __shared__ __align__(16) float Bs[kBK][kBStride];   // Bs[k][n] = B[k0 + k][n0 + n]

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);        // column patch
  const int ty = tid / (kBN / kTN);        // row patch
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const long long bz = blockIdx.z;
  const TA* Ab = A + bz * sAb;
  const TB* Bb = B + bz * sBb;
  // load along whichever axis is contiguous, so neighbouring threads read
  // neighbouring addresses
  const bool a_k_fast = sAk == 1;
  const bool b_n_fast = sBn == 1 || sBk != 1;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int m = a_k_fast ? idx / kBK : idx % kBM;
      const int k = a_k_fast ? idx % kBK : idx / kBM;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(Ab[gm * sAm + gk * sAk]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int k = b_n_fast ? idx / kBN : idx % kBK;
      const int n = b_n_fast ? idx % kBN : idx / kBK;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(Bb[gk * sBk + gn * sBn]) : 0.0f;
    }
    __syncthreads();

    float part[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  float* Cb = C + bz * static_cast<long long>(M) * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) Cb[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <typename TA, typename TB>
cudaError_t launch(const void* A, long long sAb, long long sAm, long long sAk, const void* B,
                   long long sBb, long long sBk, long long sBn, float* C, int batch, int M,
                   int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  tiled_matmul_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(A), sAb, sAm, sAk, static_cast<const TB*>(B), sBb, sBk, sBn, C,
      M, N, K);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t launch_b(int b_dtype, const void* A, long long sAb, long long sAm, long long sAk,
                     const void* B, long long sBb, long long sBk, long long sBn, float* C,
                     int batch, int M, int N, int K, cudaStream_t stream) {
  switch (b_dtype) {
    case kF32:
      return launch<TA, float>(A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, batch, M, N, K, stream);
    case kF64:
      return launch<TA, double>(A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, batch, M, N, K, stream);
    case kBF16:
      return launch<TA, __nv_bfloat16>(A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, batch, M, N, K,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C (batch, M, N) float32 contiguous = A (batch, M, K) . B (batch, K, N), with
// A and B given by their element strides (s?b the batch stride, 0 for a
// broadcast operand) and dtype codes 0 float32, 1 float64, 2 bfloat16.
// Requires batch <= 65535.  Returns cudaGetLastError() after the launch.
extern "C" int tiled_matmul(const void* A, int a_dtype, long long sAb, long long sAm,
                            long long sAk, const void* B, int b_dtype, long long sBb,
                            long long sBk, long long sBn, void* C, int batch, int M, int N,
                            int K, void* stream) {
  if (batch == 0 || M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* Cf = static_cast<float*>(C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_dtype) {
    case kF32:
      return launch_b<float>(b_dtype, A, sAb, sAm, sAk, B, sBb, sBk, sBn, Cf, batch, M, N, K, s);
    case kF64:
      return launch_b<double>(b_dtype, A, sAb, sAm, sAk, B, sBb, sBk, sBn, Cf, batch, M, N, K,
                              s);
    case kBF16:
      return launch_b<__nv_bfloat16>(b_dtype, A, sAb, sAm, sAk, B, sBb, sBk, sBn, Cf, batch, M,
                                     N, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
