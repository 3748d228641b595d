// Mamba2 SSD (state-space duality) scan: chunked intra-chunk products plus
// a sequential inter-chunk state recurrence, with the final state.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel
// `_ssd_kernel`) in the model's layout, the function of
// src/repro/models/layers.py::_ssd_chunked:
//
//   y_t = Σ_{k ≤ t} exp(cs_t − cs_k) (C_t·B_k) dt_k x_k,   cs = cumsum(dt·A),
//
// and the state after the last position, S = Σ_k exp(cs_S − cs_k) dt_k x_k ⊗ B_k
// (the decode cache; the TPU kernel keeps it in VMEM scratch and drops it).
// x (B, S, H, hd), dt (B, S, H), A (H,), B and C (B, S, N), all float32 and
// read through element strides; B and C are shared by every head (one SSM
// group) and read by batch entry, never repeated per head.  y is a
// contiguous (B, S, H, hd) float32 array, the state a contiguous
// (B, H, hd, N) one.
//
// Grid (H, B), 256 threads: a block owns one (b, h) and walks its sequence
// in chunks of kL = 64 positions (the kernel's own chunk length; it changes
// only the rounding, not the function).  The (hd x N) state stays in shared
// memory from chunk to chunk.  For each chunk it stages x, B (position-major)
// and C (state-major), takes the chunk's cumulative log-decay as one thread's
// running sum (in order, as the reference's cumsum: a tree scan would round
// neighbouring sums apart by several ulps, and exp(cs_q − cs_k) of large
// |cs| would carry that), and then runs four 64-wide products, each thread a
// 4 x 4 patch of a
// 64 x 64 output tile:
//   M[q][k] = (C_q·B_k) exp(cs_q − cs_k) dt_k  for k ≤ q, else 0 — masked
//             before the exponential, so no exp of a positive argument;
//   y_q     = exp(cs_q) C_q·S_in + Σ_k M[q][k] x_k;
//   S      ← exp(cs_end) S + Σ_k exp(cs_end − cs_k) dt_k B_k ⊗ x_k.
// hd and N are zero-padded to multiples of 64 in shared memory; positions
// past S read as zero (dt = 0 keeps the decay flat) and the chunk's end is
// its last real position.  Large |dt·A| makes the
// exponentials underflow to 0, as in the reference.
//
// Bound on an H100: at the mamba2-370m prefill shapes (B 8, S 2048, H 32,
// hd 64, N 128) the chunked algorithm is ~7e10 float32 operations (C·Bᵀ
// counted once a batch entry and chunk) against ~0.3 GB: operations, ~1 ms
// at 67 TFLOP/s.  This kernel recomputes C·Bᵀ for every head (32x that
// product) and runs float32 FMAs on the CUDA cores; sharing C·Bᵀ across the
// heads of a batch entry and tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;          // positions a chunk
constexpr int kCTS = kL + 1;    // row stride of the state-major C chunk
constexpr int kMTS = kL + 4;    // row stride of M, key-major

struct Geometry {
  int S, H, hd, N, HP, NP;
  long long xs[4], dts[3], bs[3], cs[3];   // element strides
};

long long smem_floats(int HP, int NP) {
  return static_cast<long long>(kL) * (NP + 4)   // B chunk, position-major
         + static_cast<long long>(NP) * kCTS     // C chunk, state-major
         + static_cast<long long>(kL) * HP       // x chunk
         + static_cast<long long>(kL) * kMTS     // M, key-major
         + static_cast<long long>(NP) * HP       // state, state-major
         + 4LL * kL;                             // dt, cs, exp(cs), w
}

int pad64(int n) { return (n + 63) / 64 * 64; }

// acc[r][j] += Σ_t A(ty*4 + r, t) · B(t, tx + 16 j), A(i, t) = A[i*sa_i + t*sa_t],
// B(t, j) = B[t*sb_t + j]
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* A, int sa_i, int sa_t,
                                         const float* B, int sb_t, int T, int ty, int tx) {
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    float a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty * 4 + r) * sa_i + t * sa_t];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[t * sb_t + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], bb[j], acc[r][j]);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ state,
           const Geometry g) {
  extern __shared__ float4 smem4[];
  const int HP = g.HP, NP = g.NP, BNS = NP + 4;
  float* Bn = reinterpret_cast<float*>(smem4);  // [kL][BNS]  B rows (scaled by w for the state update)
  float* Ct = Bn + kL * BNS;                    // [NP][kCTS] C, state-major
  float* xs = Ct + NP * kCTS;                   // [kL][HP]
  float* Mt = xs + kL * HP;                     // [kL][kMTS] Mt[k][q] = M[q][k]
  float* st = Mt + kL * kMTS;                   // [NP][HP]   running state, st[n][d] = S[d][n]
  float* dtc = st + NP * HP;                    // [kL]
  float* cs = dtc + kL;                         // [kL] cumulative dt·A in the chunk
  float* ecs = cs + kL;                         // [kL] exp(cs)
  float* w = ecs + kL;                          // [kL] exp(cs_end − cs_k)·dt_k

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];
  const float* xb = x + b * g.xs[0] + h * g.xs[2];
  const float* dtb = dt + b * g.dts[0] + h * g.dts[2];
  const float* Bb = Bm + b * g.bs[0];
  const float* Cb = Cm + b * g.cs[0];
  float* yb = y + (static_cast<long long>(b) * g.S * g.H + h) * g.hd;
  const long long y_row = static_cast<long long>(g.H) * g.hd;

  for (int i = tid; i < NP * HP; i += kThreads) st[i] = 0.f;

  for (int s0 = 0; s0 < g.S; s0 += kL) {
    for (int i = tid; i < kL * HP; i += kThreads) {
      const int kk = i / HP, d = i % HP, s = s0 + kk;
      xs[i] = (s < g.S && d < g.hd) ? xb[s * g.xs[1] + d * g.xs[3]] : 0.f;
    }
    for (int i = tid; i < kL * NP; i += kThreads) {
      const int kk = i / NP, n = i % NP, s = s0 + kk;
      const bool ok = s < g.S && n < g.N;
      Bn[kk * BNS + n] = ok ? Bb[s * g.bs[1] + n * g.bs[2]] : 0.f;
      Ct[n * kCTS + kk] = ok ? Cb[s * g.cs[1] + n * g.cs[2]] : 0.f;
    }
    if (tid < kL) dtc[tid] = (s0 + tid < g.S) ? dtb[(s0 + tid) * g.dts[1]] : 0.f;
    __syncthreads();

    if (tid == 0) {   // cumulative dt·A, in order: neighbouring cs differ by dt·A to ½ ulp
      float run = 0.f;
#pragma unroll 16
      for (int t = 0; t < kL; ++t) {
        run = __fadd_rn(run, __fmul_rn(dtc[t], a_h));
        cs[t] = run;
      }
    }
    __syncthreads();
    // the decay to the chunk's last real position: the very number its own
    // cs holds, so that position's weight is exp(0) = 1 exactly (at large
    // |dt·A| a rounding of cs_end against cs_k would scale it by exp(±ulp))
    const float cs_end = cs[min(kL, g.S - s0) - 1];
    if (tid < kL) {
      ecs[tid] = expf(cs[tid]);
      w[tid] = expf(cs_end - cs[tid]) * dtc[tid];
    }

    {  // M, from C·Bᵀ computed key-major: out[k][q] = Σ_n B[k][n] C[q][n]
      float acc[4][4] = {};
      mma_tile(acc, Bn, BNS, 1, Ct, kCTS, NP, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kk = ty * 4 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = tx + 16 * j;
          Mt[kk * kMTS + qq] = kk <= qq ? acc[r][j] * expf(cs[qq] - cs[kk]) * dtc[kk] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(cs_q) C_q·S_in + M·x
    for (int d0 = 0; d0 < HP; d0 += 64) {
      float acc[4][4] = {};
      mma_tile(acc, Ct, 1, kCTS, st + d0, HP, NP, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecs[ty * 4 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] *= e;
      }
      mma_tile(acc, Mt, 1, kMTS, xs + d0, HP, kL, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = s0 + ty * 4 + r;
        if (s >= g.S) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + tx + 16 * j;
          if (d < g.hd) yb[s * y_row + d] = acc[r][j];
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < kL * NP; i += kThreads) {
      const int kk = i / NP, n = i % NP;
      Bn[kk * BNS + n] *= w[kk];
    }
    __syncthreads();

    // S ← exp(cs_end) S + Σ_k (w_k B_k) ⊗ x_k
    const float dec = expf(cs_end);
    for (int n0 = 0; n0 < NP; n0 += 64) {
      for (int d0 = 0; d0 < HP; d0 += 64) {
        float acc[4][4] = {};
        mma_tile(acc, Bn + n0, 1, BNS, xs + d0, HP, kL, ty, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* p = &st[(n0 + ty * 4 + r) * HP + d0 + tx + 16 * j];
            *p = *p * dec + acc[r][j];
          }
      }
    }
    __syncthreads();
  }

  float* sb = state + (static_cast<long long>(b) * g.H + h) * g.hd * g.N;
  for (int i = tid; i < g.hd * g.N; i += kThreads) {
    const int d = i / g.N, n = i % g.N;
    sb[i] = st[n * HP + d];
  }
}

}  // namespace

// Dynamic shared memory a block takes for head size hd and state size N.
extern "C" long long ssd_scan_smem_bytes(int hd, int N) {
  return smem_floats(pad64(hd), pad64(N)) * static_cast<long long>(sizeof(float));
}

// x (Bsz, S, H, hd), dt (Bsz, S, H), A (H,), Bm and Cm (Bsz, S, N), float32;
// strides: 13 element strides, x (b, s, h, d), dt (b, s, h), Bm (b, s, n),
// Cm (b, s, n); y: contiguous (Bsz, S, H, hd), state: contiguous
// (Bsz, H, hd, N).  Returns cudaGetLastError() after the launch (or the
// shared-memory opt-in's error).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state, int Bsz, int S, int H,
                            int hd, int N, const long long* strides, void* stream) {
  if (Bsz == 0 || H == 0 || hd == 0 || N == 0) return static_cast<int>(cudaSuccess);
  Geometry g;
  g.S = S; g.H = H; g.hd = hd; g.N = N;
  g.HP = pad64(hd);
  g.NP = pad64(N);
  for (int i = 0; i < 4; ++i) g.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    g.dts[i] = strides[4 + i];
    g.bs[i] = strides[7 + i];
    g.cs[i] = strides[10 + i];
  }
  const long long smem = smem_floats(g.HP, g.NP) * static_cast<long long>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, Bsz);
  ssd_kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), g);
  return static_cast<int>(cudaGetLastError());
}
