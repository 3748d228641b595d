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
// Summation, in every template: each 32-wide slice of K is summed into a
// fresh partial, in ascending k, and the partials are added to the running
// sum in order (chunked summation: at K = 1200 one running sum would sit
// near the 1e-5 contract against float64).  Ragged edges read as zeros,
// which gives the reference's zero padding without padded copies.  Offsets
// are 64-bit: A on the Newton-XL path is 512 x 1200 x 1200 float64, 5.9 GB.
//
// Bound on an H100: the Γ path's first product T = A_i V_i reads A once,
// 5.9 GB at fig1-xl's widths, about 1.8 ms at 3.35 TB/s, against 4.7e10
// operations, 0.70 ms at 67 TFLOP/s: bytes.  The second, Γ = V_iᵀ T_i, is
// 32 x 32 per client over K = 1200: 0.24 GB, bytes again, with only 512
// output tiles.
//
// Two templates, chosen by the Python wrapper's plan (`tiled_matmul.plan`)
// from the operands' layout and shape, never on an error:
//
//  * stream_kernel — for operands whose contiguous axis has unit stride and
//    whose other strides and base address are 16-byte aligned.  A ring of
//    (bm x 32) / (32 x bn) raw tiles in shared memory is filled by 16-byte
//    cp.async copies (zero-filled past the edges), the next stage issued
//    before the threads wait for this one, convert it to float32 (once per
//    element) and run its FMAs, so a copy is in flight through every step.
//    Tall tiles (bm 128, 256 threads, 2 stages, two 108.5 KB blocks an SM)
//    for M > 32 halve the L2 re-reads of a narrow B against the general
//    template; small tiles (bm 32, 128 threads, 3 stages) for M <= 32 waste
//    no loads on padding.  Each block walks the whole of K for its tile and
//    writes it once (no atomics: a rerun is bitwise equal).  K is not split
//    across blocks: Γ's 512 tiles fill the card, and split 2-8 ways it
//    measured slower on an H100.
//  * tiled_matmul_kernel — the general template (any strides, any
//    alignment): each thread loads one element at a time through its
//    strides; 64 x 32 tiles, K in steps of 32, no copy in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
enum Template : int { kGeneral = 0, kStreamTall = 1, kStreamSmall = 2 };
// the stream templates' stage depth and ring depth (measured on an H100 at
// Newton-XL's T and Γ: two 108.5 KB tall blocks an SM beat deeper rings at
// one block an SM)
constexpr int kTallBK = 32, kTallStages = 2;
constexpr int kSmallBK = 32, kSmallStages = 3;

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

// ---------------------------------------------------------------------------
// stream template: cp.async ring, float32 conversion once

constexpr int kSChunk = 32;     // K depth of one summation partial
constexpr int kSBN = 32;
constexpr int kSTN = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A raw stage holds one operand tile as copied: `outer` rows of `inner`
// elements (the contiguous axis), each row padded by 16 bytes so that a
// column walk over rows (a transposing conversion) spreads over the banks.
__host__ __device__ constexpr int raw_pitch(int inner, int esize) { return inner * esize + 16; }
__host__ __device__ constexpr int raw_bytes(int outer, int inner, int esize) {
  return outer * raw_pitch(inner, esize);
}
// room for one operand's (mn x bk) stage in either layout (rows along the
// tile's K side or along its M / N side)
__host__ __device__ constexpr int stage_bytes(int mn, int bk, int esize) {
  return raw_bytes(mn, bk, esize) > raw_bytes(bk, mn, esize) ? raw_bytes(mn, bk, esize)
                                                             : raw_bytes(bk, mn, esize);
}
__host__ __device__ constexpr int stream_smem_bytes(int bm, int bk, int stages, int ea,
                                                    int eb) {
  return stages * (stage_bytes(bm, bk, ea) + stage_bytes(kSBN, bk, eb))
         + bk * (bm + 4) * 4 + bk * (kSBN + 4) * 4;
}

struct StreamArgs {
  const void* A;
  long long sAb, sAm, sAk;
  const void* B;
  long long sBb, sBk, sBn;
  float* C;
  int M, N, K;
  int a_inner_k, b_inner_k;   // 1: the operand's contiguous axis is K
};

// Copy one operand tile into a raw stage: logical tile rows x cols where
// the contiguous axis is `inner` (extent `inner_n`, starting at `inner0`,
// valid below `inner_lim`), the other `outer` (extent `outer_n` from
// `outer0`, valid below `outer_lim`, element stride `s_outer`).
template <typename T, int NT>
__device__ __forceinline__ void load_tile(unsigned char* raw, const T* base, long long s_outer,
                                          int outer0, int outer_n, int outer_lim, int inner0,
                                          int inner_n, int inner_lim) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = inner_n / V;
  const int pitch = raw_pitch(inner_n, sizeof(T));
  for (int idx = threadIdx.x; idx < outer_n * chunks; idx += NT) {
    const int o = idx / chunks, c = idx % chunks;
    const int go = outer0 + o, gi = inner0 + c * V;
    int bytes = 0;
    const T* src = base;
    if (go < outer_lim && gi < inner_lim) {
      bytes = (inner_lim - gi >= V ? V : inner_lim - gi) * static_cast<int>(sizeof(T));
      src = base + static_cast<long long>(go) * s_outer + gi;
    }
    cp_async16(raw + o * pitch + c * 16, src, bytes);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[2], double) {
  double2 d;
  memcpy(&d, &u, 16);
  v[0] = static_cast<float>(d.x);
  v[1] = static_cast<float>(d.y);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4], float) {
  memcpy(v, &u, 16);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8], __nv_bfloat16) {
  __nv_bfloat162 h[4];
  memcpy(h, &u, 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Convert a raw stage to the float32 k-major tile dst[k][mn] (row stride
// `dpitch` floats).  inner_k: raw rows are mn, inner axis k (a transposing
// walk, neighbouring threads on neighbouring rows); else raw rows are k,
// inner axis mn (neighbouring threads on neighbouring 16-byte chunks).
template <typename T, int NT, int BK>
__device__ __forceinline__ void convert_tile(const unsigned char* raw, int mn, bool inner_k,
                                             float* dst, int dpitch) {
  constexpr int V = 16 / sizeof(T);
  if (inner_k) {
    constexpr int chunks = BK / V;
    const int pitch = raw_pitch(BK, sizeof(T));
    for (int idx = threadIdx.x; idx < mn * chunks; idx += NT) {
      const int o = idx % mn, c = idx / mn;
      float v[V];
      unpack(*reinterpret_cast<const uint4*>(raw + o * pitch + c * 16), v, T());
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(c * V + j) * dpitch + o] = v[j];
    }
  } else {
    const int chunks = mn / V;
    const int pitch = raw_pitch(mn, sizeof(T));
    for (int idx = threadIdx.x; idx < BK * chunks; idx += NT) {
      const int c = idx % chunks, o = idx / chunks;
      float v[V];
      unpack(*reinterpret_cast<const uint4*>(raw + o * pitch + c * 16), v, T());
      float* d = dst + o * dpitch + c * V;
      if constexpr (V == 2) {
        *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
      } else {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(d + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  }
}

// Grid (n_tiles, m_tiles, batch): one (BM x 32) tile of C of one batch
// entry over the whole of K, in stages BK deep from a ring of STAGES.
// Each of BM/TM x 8 threads owns a TM x 4 patch.
template <typename TA, typename TB, int BM, int TM, int BK, int STAGES>
__global__ void __launch_bounds__((BM / TM) * (kSBN / kSTN))
stream_kernel(const StreamArgs p) {
  constexpr int NT = (BM / TM) * (kSBN / kSTN);
  constexpr int AP = BM + 4, BP = kSBN + 4;       // float32 tile row strides
  constexpr int kStageA = stage_bytes(BM, BK, sizeof(TA));
  constexpr int kStageB = stage_bytes(kSBN, BK, sizeof(TB));
  static_assert(BK % kSChunk == 0, "a stage holds whole summation partials");
  extern __shared__ __align__(16) unsigned char smem[];
  float* F = reinterpret_cast<float*>(smem + STAGES * (kStageA + kStageB));  // float32 [A | B]

  const int tid = threadIdx.x;
  const int tx = tid % (kSBN / kSTN), ty = tid / (kSBN / kSTN);
  const int n0 = blockIdx.x * kSBN;
  const int m0 = blockIdx.y * BM;
  const long long bz = blockIdx.z;
  const TA* Ab = static_cast<const TA*>(p.A) + bz * p.sAb;
  const TB* Bb = static_cast<const TB*>(p.B) + bz * p.sBb;
  const int steps = (p.K + BK - 1) / BK;

  auto issue = [&](int i) {     // stage i into slot i % STAGES
    if (i >= steps) return;
    unsigned char* ra = smem + (i % STAGES) * (kStageA + kStageB);
    unsigned char* rb = ra + kStageA;
    const int k0 = i * BK;
    if (p.a_inner_k)
      load_tile<TA, NT>(ra, Ab, p.sAm, m0, BM, p.M, k0, BK, p.K);
    else
      load_tile<TA, NT>(ra, Ab, p.sAk, k0, BK, p.K, m0, BM, p.M);
    if (p.b_inner_k)
      load_tile<TB, NT>(rb, Bb, p.sBn, n0, kSBN, p.N, k0, BK, p.K);
    else
      load_tile<TB, NT>(rb, Bb, p.sBk, k0, BK, p.K, n0, kSBN, p.N);
  };
  auto convert = [&](int i) {   // stage i into the float32 tiles
    const unsigned char* ra = smem + (i % STAGES) * (kStageA + kStageB);
    convert_tile<TA, NT, BK>(ra, BM, p.a_inner_k, F, AP);
    convert_tile<TB, NT, BK>(ra + kStageA, kSBN, p.b_inner_k, F + BK * AP, BP);
  };

  float acc[TM][kSTN], part[TM][kSTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kSTN; ++j) acc[i][j] = part[i][j] = 0.0f;
  // a partial covers one 32-wide slice of K (stages start on a slice
  // boundary; past K the slice reads zeros), then joins the running sum in
  // order
  auto flush = [&]() {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < kSTN; ++j) {
        acc[r][j] += part[r][j];
        part[r][j] = 0.0f;
      }
  };
  auto fma_stage = [&](const float* As) {
    const float* Bs = As + BK * AP;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[kSTN];
      if constexpr (TM == 4) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k * AP + ty * TM]);
        av[0] = a.x; av[1] = a.y; av[2] = a.z; av[3] = a.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(&As[k * AP + ty * TM]);
        av[0] = a.x; av[1] = a.y;
      }
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k * BP + tx * kSTN]);
      bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < kSTN; ++j) part[r][j] = fmaf(av[r], bv[j], part[r][j]);
      if (k % kSChunk == kSChunk - 1) flush();
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    // slot (i + STAGES − 1) % STAGES held stage i − 1, converted before the
    // last barrier: refill it first, so STAGES − 1 stages stay in flight
    // through this step's wait, conversion and FMAs
    issue(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // this thread's copies of stage i landed
    __syncthreads();               // everyone's; and the float32 tile is free
    convert(i);
    __syncthreads();               // float32 tile ready
    fma_stage(F);
  }

  float* Cb = p.C + bz * static_cast<long long>(p.M) * p.N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty * TM + r;
    if (gm >= p.M) continue;
    float* row = Cb + static_cast<long long>(gm) * p.N;
    const int gn = n0 + tx * kSTN;
    if ((p.N & 3) == 0 && gn + kSTN <= p.N) {
      *reinterpret_cast<float4*>(row + gn) = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                                         acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kSTN; ++j)
        if (gn + j < p.N) row[gn + j] = acc[r][j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// what stream_kernel needs of an operand: unit stride on the contiguous
// axis (checked by the planner) and 16-byte alignment of its base and of
// every other stride
bool stream_ok(const void* p, int esize, long long s_batch, long long s_outer) {
  const long long v = 16 / esize;
  return aligned16(p) && s_batch % v == 0 && s_outer % v == 0;
}

template <typename TA, typename TB, int BM, int TM, int BK, int STAGES>
cudaError_t launch_stream(const StreamArgs& p, int batch, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (kSBN / kSTN);
  constexpr int smem = stream_smem_bytes(BM, BK, STAGES, sizeof(TA), sizeof(TB));
  if (!stream_ok(p.A, sizeof(TA), p.sAb, p.a_inner_k ? p.sAm : p.sAk) ||
      !stream_ok(p.B, sizeof(TB), p.sBb, p.b_inner_k ? p.sBn : p.sBk) ||
      (p.a_inner_k ? p.sAk : p.sAm) != 1 || (p.b_inner_k ? p.sBk : p.sBn) != 1)
    return cudaErrorInvalidValue;
  auto kernel = stream_kernel<TA, TB, BM, TM, BK, STAGES>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + kSBN - 1) / kSBN, (p.M + BM - 1) / BM, batch);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch(int tmpl, const void* A, long long sAb, long long sAm, long long sAk,
                   const void* B, long long sBb, long long sBk, long long sBn, float* C,
                   int batch, int M, int N, int K, int a_inner_k, int b_inner_k,
                   cudaStream_t stream) {
  if (tmpl == kGeneral) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
    tiled_matmul_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(A), sAb, sAm, sAk, static_cast<const TB*>(B), sBb, sBk, sBn, C,
        M, N, K);
    return cudaGetLastError();
  }
  const StreamArgs p{A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, M, N, K, a_inner_k, b_inner_k};
  if (tmpl == kStreamTall)
    return launch_stream<TA, TB, 128, 4, kTallBK, kTallStages>(p, batch, stream);
  if (tmpl == kStreamSmall)
    return launch_stream<TA, TB, 32, 2, kSmallBK, kSmallStages>(p, batch, stream);
  return cudaErrorInvalidValue;
}

template <typename TA>
cudaError_t launch_b(int b_dtype, int tmpl, const void* A, long long sAb, long long sAm,
                     long long sAk, const void* B, long long sBb, long long sBk, long long sBn,
                     float* C, int batch, int M, int N, int K, int a_inner_k, int b_inner_k,
                     cudaStream_t s) {
  switch (b_dtype) {
    case kF32:
      return launch<TA, float>(tmpl, A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, batch, M, N, K,
                               a_inner_k, b_inner_k, s);
    case kF64:
      return launch<TA, double>(tmpl, A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, batch, M, N, K,
                                a_inner_k, b_inner_k, s);
    case kBF16:
      return launch<TA, __nv_bfloat16>(tmpl, A, sAb, sAm, sAk, B, sBb, sBk, sBn, C, batch, M,
                                       N, K, a_inner_k, b_inner_k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C (batch, M, N) float32 contiguous = A (batch, M, K) . B (batch, K, N), with
// A and B given by their element strides (s?b the batch stride, 0 for a
// broadcast operand) and dtype codes 0 float32, 1 float64, 2 bfloat16.
// The plan (see tiled_matmul.plan): template 0 general, 1 stream with tall
// tiles, 2 stream with small tiles, and for the stream templates whether
// each operand's contiguous axis is K.  A plan the operands do not meet
// returns cudaErrorInvalidValue without a launch.  Requires batch <= 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int tiled_matmul(const void* A, int a_dtype, long long sAb, long long sAm,
                            long long sAk, const void* B, int b_dtype, long long sBb,
                            long long sBk, long long sBn, void* C, int batch, int M, int N,
                            int K, int tmpl, int a_inner_k, int b_inner_k, void* stream) {
  if (batch == 0 || M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* Cf = static_cast<float*>(C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_dtype) {
    case kF32:
      return launch_b<float>(b_dtype, tmpl, A, sAb, sAm, sAk, B, sBb, sBk, sBn, Cf, batch, M,
                             N, K, a_inner_k, b_inner_k, s);
    case kF64:
      return launch_b<double>(b_dtype, tmpl, A, sAb, sAm, sAk, B, sBb, sBk, sBn, Cf, batch, M,
                              N, K, a_inner_k, b_inner_k, s);
    case kBF16:
      return launch_b<__nv_bfloat16>(b_dtype, tmpl, A, sAb, sAm, sAk, B, sBb, sBk, sBn, Cf,
                                     batch, M, N, K, a_inner_k, b_inner_k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
