// The gradient of the Mamba2 SSD chunked scan: dx, ddt, dA, dB and dC of
//
//   y_t = Σ_{k ≤ t} exp(cs_t − cs_k) (C_t·B_k) dt_k x_k,   cs = cumsum(dt·A),
//
// and of the state after the last position, given dy and, optionally, the
// final state's gradient.
//
// Replaces no TPU kernel: the reference differentiates
// src/repro/models/layers.py::_ssd_chunked (the function of the Pallas
// kernel src/repro/kernels/ssd_scan.py::ssd_scan) with jax.grad, and the
// port's forward is a hand-written kernel (ssd_scan.cu), so training on the
// card needs this backward.  Layout as the forward: x (B, S, H, hd), dt
// (B, S, H), A (H,), B and C (B, S, N) shared by the heads, float32, read
// through element strides; dy (B, S, H, hd) and the state's gradient
// (B, H, hd, N) contiguous.  dx, ddt, dB and dC are contiguous arrays of the
// inputs' shapes, dA an (H,) array, all float32.
//
// It reads the forward's workspace, left by the forward call on the same
// inputs (ssd_scan.cu, kL = 128-position chunks): C·Bᵀ (k ≤ q) and the
// state entering each chunk, S_in.  The in-chunk cumulative decays cs it
// sums again, in double: the forward's are float32, and where a chunk's
// decays are strong, cs runs to −10⁴ while two neighbours differ by −0.05,
// so cs_q − cs_k of float32 sums is off by ~1e-3 and L by as much, which
// ddt, a sum of such terms times A, carries to ~2e-4 of its largest value.
// With u = dt·x, L_qk = exp(cs_q − cs_k) (q ≥ k), each difference taken in
// double and rounded once, and R_c the gradient of the state after chunk c:
//
//   R_{c−1} = exp(cs_end,c)·R_c + Σ_q exp(cs_q) dy_q ⊗ C_q   (reverse order)
//   du_k  = Σ_{q ≥ k} L_qk (C_q·B_k) dy_q + exp(cs_end − cs_k) R_c B_k
//   dC_q  = Σ_h [Σ_{k ≤ q} L_qk (dy_q·u_k) B_k + exp(cs_q) S_inᵀ dy_q]
//   dB_k  = Σ_h [Σ_{q ≥ k} L_qk (dy_q·u_k) C_q + exp(cs_end − cs_k) R_cᵀ u_k]
//   dcs   from the same terms (each pair's exp(cs_q − cs_k) gives +Z to
//         q and −Z to k), the reverse in-chunk cumsum of dcs is d(dt·A),
//   dx = dt·du,  ddt = x·du + A·d(dt·A),  dA = Σ dt·d(dt·A).
//
// Five launches, every sum with one owner in a fixed order (no atomics: a
// rerun gives the same bits):
//   1. ssd_bwd_e_kernel, per (b, h, chunk): cs in double and the chunk's
//      decay exp(cs_end), kept for the launches after it; then
//      Σ_q exp(cs_q) dy_qᵀ C_q (hd x N) into a workspace the size of the
//      forward's chunk states;
//   2. ssd_bwd_pass_kernel, per (b, h) state element, in reverse chunk
//      order: R_c over it in place, from the final state's gradient (or 0);
//   3. ssd_bwd_head_kernel, per (b, h, chunk): dy·uᵀ masked by L and C·Bᵀ,
//      its strict row and column sums; C·S_inᵀ (dcs's read-out term); R·B
//      (du's state term, and the key side of dcs); Pᵀ·dy (du's chunk
//      term); then dx, x·du, and one thread's reverse cumsum over the
//      chunk: ddt and the chunk's share of dA;
//   4. ssd_bwd_bc_kernel, per (b, chunk): Σ_h L∘(dy·uᵀ) once, then dC and
//      dB as one product each with it plus, per head, the state terms — so
//      the sum over the heads that share B and C is a loop in order;
//   5. ssd_bwd_da_kernel: dA, summing the chunks' shares over (b, chunk).
// dA sums d(dt·A) over every position, and those terms cancel, so its
// shares (and the in-chunk reverse cumsum they come from) are summed in
// double, then rounded once.
// Every product is a 128-row tile with 256 threads, 8 rows x W/16 columns a
// thread, its operands staged through shared memory 16 deep (`gemm`),
// float32 FMAs on the CUDA cores.
//
// Bound on an H100: at mamba2-370m's training shapes (B 8, S 4096, H 32,
// hd 64, N 128) the gradient is ~1.2e11 float32 operations at kL = 128
// (chip_smoke.ssd_bwd_ops_bytes counts them) against ~1.2 GB of inputs,
// saved states and outputs: operations, ~0.74 ms as three split TF32
// products on the tensor cores (the card's float32 peak), ~1.8 ms at the
// CUDA cores' 67 TFLOP/s, which these FMAs run at.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;          // positions a chunk (the forward's)
constexpr int kThreads = 256;
constexpr int kSlab = 16;        // contraction depth staged at a time
constexpr int kLA = kL + 4;      // row stride of a staged A slab
constexpr int kLB = kL + 4;      // row stride of a staged B slab (W ≤ 128)
constexpr int kLZ = kL + 1;      // row stride of a chunk's (q, k) matrix
constexpr int kMaxPad = 128;

struct Geometry {
  int Bsz, S, H, hd, N, nc;
  long long xs[4], dts[3], bs[3], cs[3];   // element strides
};

// the forward's workspace (ssd_scan.cu, ws_floats): cs (Bsz, nc, H, kL),
// decays (Bsz, nc, H), C·Bᵀ (Bsz, nc, kL, kL), chunk states (Bsz, nc, H, hd, N);
// of these the backward reads C·Bᵀ and the states.  csd and dec: the
// backward's own cs in double (Bsz, nc, H, kL) and exp(cs_end) (Bsz, nc, H),
// which launch 1 writes
struct Work {
  const float *cs, *dec, *cb, *st;
  double* csd;
  float* decd;
};

long long ws_floats(const Geometry& g, Work* w, const float* base) {
  auto up4 = [](long long n) { return (n + 3) / 4 * 4; };
  const long long bc = static_cast<long long>(g.Bsz) * g.nc;
  const long long n_cs = up4(bc * g.H * kL), n_dec = up4(bc * g.H), n_cb = up4(bc * kL * kL);
  const long long n_st = up4(bc * g.H * static_cast<long long>(g.hd) * g.N);
  if (w != nullptr) {
    w->cs = base;
    w->dec = w->cs + n_cs;
    w->cb = w->dec + n_dec;
    w->st = w->cb + n_cb;
  }
  return n_cs + n_dec + n_cb + n_st;
}

// acc[i][j] += Σ_k a(row, k)·b(k, col) over k < K for rows ty + 16i (i < 8)
// and columns tx + 16j (j < J) of a 128 x 16J tile.  Slabs of 16 are staged
// in shared memory; AK (BK) stages A (B) with k the fastest index across
// threads (the operand contiguous in k), else rows (columns) fastest.
template <int J, bool AK, bool BK, typename FA, typename FB>
__device__ __forceinline__ void gemm(float (&acc)[8][J], int K, FA a, FB b, float* As,
                                     float* Bs) {
  constexpr int W = 16 * J;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    __syncthreads();
    for (int e = tid; e < kSlab * kL; e += kThreads) {
      const int row = AK ? e >> 4 : e & (kL - 1), kk = AK ? e & 15 : e >> 7;
      As[kk * kLA + row] = k0 + kk < K ? a(row, k0 + kk) : 0.f;
    }
    for (int e = tid; e < kSlab * W; e += kThreads) {
      const int col = BK ? e >> 4 : e % W, kk = BK ? e & 15 : e / W;
      Bs[kk * kLB + col] = k0 + kk < K ? b(k0 + kk, col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float av[8], bv[J];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[kk * kLA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < J; ++j) bv[j] = Bs[kk * kLB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[8][J]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

// the sum of v over the 16 threads that share a row (lanes tx of one ty)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// exp(a − b) of two cumulative decays: the difference in double, rounded once
__device__ __forceinline__ float lexp(double a, double b) {
  return expf(static_cast<float>(a - b));
}

constexpr long long gemm_floats() { return 2LL * kSlab * kLA; }

// Inputs of one (b, chunk) as functions of (position in the chunk, column),
// zero past S and past the width.
struct Chunk {
  const Geometry& g;
  int b, s0, real;
  __device__ float x(const float* p, int h, int t, int d) const {
    return t < real && d < g.hd
               ? p[b * g.xs[0] + (s0 + t) * g.xs[1] + h * g.xs[2] + d * g.xs[3]]
               : 0.f;
  }
  __device__ float dt(const float* p, int h, int t) const {
    return t < real ? p[b * g.dts[0] + (s0 + t) * g.dts[1] + h * g.dts[2]] : 0.f;
  }
  __device__ float bm(const float* p, int t, int n) const {
    return t < real && n < g.N ? p[b * g.bs[0] + (s0 + t) * g.bs[1] + n * g.bs[2]] : 0.f;
  }
  __device__ float cm(const float* p, int t, int n) const {
    return t < real && n < g.N ? p[b * g.cs[0] + (s0 + t) * g.cs[1] + n * g.cs[2]] : 0.f;
  }
  __device__ float dy(const float* p, int h, int t, int d) const {   // contiguous
    return t < real && d < g.hd
               ? p[((static_cast<long long>(b) * g.S + s0 + t) * g.H + h) * g.hd + d]
               : 0.f;
  }
};

// ---- 1. per (b, h, chunk): Σ_q exp(cs_q) dy_qᵀ C_q --------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_e_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ Cm, const float* __restrict__ dy, const Geometry g,
                 const Work w, float* __restrict__ R) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kSlab * kLA;
  double* csS = reinterpret_cast<double*>(Bs + kSlab * kLB);   // [kL] cs
  float* xS = reinterpret_cast<float*>(csS + kL);              // [kL] exp(cs_q)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const Chunk ch{g, b, c * kL, min(kL, g.S - c * kL)};
  const long long bch = (static_cast<long long>(b) * g.nc + c) * g.H + h;
  // cs = cumsum(dt·A) in order, in double (dt·A of float32 values is exact
  // there); constant past the chunk's last real position, where dt is 0
  if (tid < kL) csS[tid] = static_cast<double>(ch.dt(dt, h, tid)) * A[h];
  __syncthreads();
  if (tid == 0) {
    double run = 0.0;
    for (int t = 0; t < kL; ++t) csS[t] = run += csS[t];
    w.decd[bch] = expf(static_cast<float>(csS[ch.real - 1]));
  }
  __syncthreads();
  if (tid < kL) {
    w.csd[bch * kL + tid] = csS[tid];
    xS[tid] = expf(static_cast<float>(csS[tid]));
  }
  float acc[8][NJ];
  zero(acc);
  gemm<NJ, false, false>(
      acc, kL, [&](int d, int q) { return xS[q] * ch.dy(dy, h, q, d); },
      [&](int q, int n) { return ch.cm(Cm, q, n); }, As, Bs);
  float* out = R + bch * g.hd * g.N;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = ty + 16 * i, n = tx + 16 * j;
      if (d < g.hd && n < g.N) out[d * g.N + n] = acc[i][j];
    }
}

// ---- 2. per (b, h) state element: R_c in reverse chunk order ----------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(const Geometry g, const Work w, float* __restrict__ R,
                    const float* __restrict__ dstate) {
  const long long hdN = static_cast<long long>(g.hd) * g.N;
  const long long total = static_cast<long long>(g.Bsz) * g.H * hdN;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long bh = e / hdN, r = e % hdN, b = bh / g.H, h = bh % g.H;
    float s = dstate != nullptr ? dstate[e] : 0.f;
    for (int c = g.nc - 1; c >= 0; --c) {
      const long long bch = (b * g.nc + c) * g.H + h;
      float* p = R + bch * hdN + r;
      const float ec = *p;
      *p = s;                                   // the gradient of the state after chunk c
      s = fmaf(s, w.decd[bch], ec);
    }
  }
}

// ---- 3. per (b, h, chunk): dx, ddt and the chunk's share of dA --------------
template <int HJ>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dy,
                    const Geometry g, const Work w, const float* __restrict__ R,
                    float* __restrict__ dx, float* __restrict__ ddt,
                    double* __restrict__ dA_part) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kSlab * kLA;
  float* Zs = Bs + kSlab * kLB;       // [kL][kLZ] strict Z, then P = L∘C·Bᵀ
  double* csS = reinterpret_cast<double*>(Zs + kL * kLZ);   // cs
  float* dtS = reinterpret_cast<float*>(csS + kL);          // dt
  float* eS = dtS + kL;               // exp(cs_end − cs_k)
  float* xS = eS + kL;                // exp(cs_q)
  float* dcsS = xS + kL;              // dcs, built up term by term
  float* colS = dcsS + kL;            // Z's column sums
  float* wS = colS + kL;              // u_k·(exp(cs_end − cs_k) R B_k)
  float* xduS = wS + kL;              // x_k·du_k
  float* red = xduS + kL;             // [kThreads]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const Chunk ch{g, b, c * kL, min(kL, g.S - c * kL)};
  const int real = ch.real;
  const long long bch = (static_cast<long long>(b) * g.nc + c) * g.H + h;
  const long long hdN = static_cast<long long>(g.hd) * g.N;
  if (tid < kL) {
    csS[tid] = w.csd[bch * kL + tid];
    dtS[tid] = ch.dt(dt, h, tid);
    wS[tid] = xduS[tid] = 0.f;
  }
  __syncthreads();
  const double cs_end = csS[real - 1];
  if (tid < kL) {
    eS[tid] = expf(static_cast<float>(cs_end - csS[tid]));
    xS[tid] = expf(static_cast<float>(csS[tid]));
  }
  auto u = [&](int t, int d) { return dtS[t] * ch.x(x, h, t, d); };

  // G = dy·uᵀ; Z = L∘(C·Bᵀ)∘G below the diagonal (its diagonal cancels in dcs)
  const float* cb = w.cb + (static_cast<long long>(b) * g.nc + c) * kL * kL;
  {
    float G[8][8];
    zero(G);
    gemm<8, true, true>(G, g.hd, [&](int q, int d) { return ch.dy(dy, h, q, d); },
                        [&](int d, int k) { return u(k, d); }, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = ty + 16 * i, k = tx + 16 * j;
        Zs[q * kLZ + k] =
            q > k ? lexp(csS[q], csS[k]) * cb[q * kL + k] * G[i][j] : 0.f;
      }
  }
  __syncthreads();
  if (tid < kL) {                     // row sums: +Z to the query side
    float s = 0.f;
    for (int k = 0; k < tid; ++k) s += Zs[tid * kLZ + k];
    dcsS[tid] = s;
  } else {                            // column sums: −Z to the key side
    const int k = tid - kL;
    float s = 0.f;
    for (int q = k + 1; q < kL; ++q) s += Zs[q * kLZ + k];
    colS[k] = s;
  }
  __syncthreads();
  for (int e = tid; e < kL * kL; e += kThreads) {
    const int q = e / kL, k = e % kL;
    Zs[q * kLZ + k] = q >= k ? lexp(csS[q], csS[k]) * cb[q * kL + k] : 0.f;
  }

  // the read-out of the entering state: dcs_q += exp(cs_q)·dy_q·(S_in C_q)
  const float* Sin = w.st + bch * hdN;
  {
    float Y[8][HJ];
    zero(Y);
    gemm<HJ, true, true>(Y, g.N, [&](int q, int n) { return ch.cm(Cm, q, n); },
                         [&](int n, int d) { return d < g.hd ? Sin[d * g.N + n] : 0.f; },
                         As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = ty + 16 * i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < HJ; ++j) part = fmaf(ch.dy(dy, h, q, tx + 16 * j), Y[i][j], part);
      part = row_sum(part);
      if (tx == 0) dcsS[q] = fmaf(xS[q], part, dcsS[q]);
    }
  }

  // du: the state term exp(cs_end − cs_k)·R B_k (and w_k = u_k·that), then
  // the chunk term Pᵀ·dy
  const float* Rc = R + bch * hdN;
  float du[8][HJ];
  zero(du);
  gemm<HJ, true, true>(du, g.N, [&](int k, int n) { return ch.bm(Bm, k, n); },
                       [&](int n, int d) { return d < g.hd ? Rc[d * g.N + n] : 0.f; }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = ty + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      du[i][j] *= eS[k];
      part = fmaf(u(k, tx + 16 * j), du[i][j], part);
    }
    part = row_sum(part);
    if (tx == 0) wS[k] = part;
  }
  gemm<HJ, false, false>(du, kL, [&](int k, int q) { return Zs[q * kLZ + k]; },
                         [&](int q, int d) { return ch.dy(dy, h, q, d); }, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = ty + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      const int d = tx + 16 * j;
      part = fmaf(ch.x(x, h, k, d), du[i][j], part);
      if (k < real && d < g.hd)
        dx[((static_cast<long long>(b) * g.S + ch.s0 + k) * g.H + h) * g.hd + d] =
            dtS[k] * du[i][j];
    }
    part = row_sum(part);
    if (tx == 0) xduS[k] = part;
  }

  // <R, S_in>, for the chunk decay's own term
  float part = 0.f;
  for (long long e = tid; e < hdN; e += kThreads) part = fmaf(Rc[e], Sin[e], part);
  red[tid] = part;
  __syncthreads();
  if (tid == 0) {
    float rs = 0.f, wsum = 0.f;
    for (int i = 0; i < kThreads; ++i) rs += red[i];
    for (int k = 0; k < real; ++k) wsum += wS[k];
    const float dcs_end = fmaf(w.decd[bch], rs, wsum);
    const float a_h = A[h];
    // the reverse cumsum and dA's share run in double: dA sums d(dt·A)
    // over every position, with cancellation between the terms
    double run = 0.0, dAp = 0.0;
    for (int t = real - 1; t >= 0; --t) {
      float dcs = dcsS[t] - wS[t] - colS[t];
      if (t == real - 1) dcs += dcs_end;
      run += dcs;                                 // d(dt·A)_t = Σ_{t' ≥ t} dcs_t'
      ddt[(static_cast<long long>(b) * g.S + ch.s0 + t) * g.H + h] =
          fmaf(a_h, static_cast<float>(run), xduS[t]);
      dAp += static_cast<double>(dtS[t]) * run;
    }
    dA_part[bch] = dAp;
  }
}

// ---- 4. per (b, chunk): dC and dB, summed over the heads in order -----------
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ dy, const Geometry g, const Work w,
                  const float* __restrict__ R, float* __restrict__ dB,
                  float* __restrict__ dC) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kSlab * kLA;
  float* Ms = Bs + kSlab * kLB;       // [kL][kLZ] Σ_h L∘(dy·uᵀ)
  double* csS = reinterpret_cast<double*>(Ms + kL * kLZ);
  float* dtS = reinterpret_cast<float*>(csS + kL);
  float* sc = dtS + kL;               // a head's row scale: exp(cs_q) or exp(cs_end − cs_k)
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const Chunk ch{g, b, c * kL, min(kL, g.S - c * kL)};
  const int real = ch.real;
  const long long bc = static_cast<long long>(b) * g.nc + c;
  const long long hdN = static_cast<long long>(g.hd) * g.N;
  auto head = [&](int h) {            // a head's cs and dt into shared memory
    __syncthreads();
    if (tid < kL) {
      csS[tid] = w.csd[(bc * g.H + h) * kL + tid];
      dtS[tid] = ch.dt(dt, h, tid);
    }
    __syncthreads();
  };

  {
    float M[8][8];
    zero(M);
    for (int h = 0; h < g.H; ++h) {
      head(h);
      float G[8][8];
      zero(G);
      gemm<8, true, true>(G, g.hd, [&](int q, int d) { return ch.dy(dy, h, q, d); },
                          [&](int d, int k) { return dtS[k] * ch.x(x, h, k, d); }, As, Bs);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = ty + 16 * i, k = tx + 16 * j;
          if (q >= k) M[i][j] = fmaf(lexp(csS[q], csS[k]), G[i][j], M[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Ms[(ty + 16 * i) * kLZ + tx + 16 * j] = M[i][j];
  }

  float acc[8][NJ];
  // dC = M·B + Σ_h exp(cs_q) dy_q S_in
  zero(acc);
  gemm<NJ, true, false>(acc, kL, [&](int q, int k) { return Ms[q * kLZ + k]; },
                        [&](int k, int n) { return ch.bm(Bm, k, n); }, As, Bs);
  for (int h = 0; h < g.H; ++h) {
    head(h);
    if (tid < kL) sc[tid] = expf(static_cast<float>(csS[tid]));
    const float* Sin = w.st + (bc * g.H + h) * hdN;
    gemm<NJ, true, false>(acc, g.hd, [&](int q, int d) { return sc[q] * ch.dy(dy, h, q, d); },
                          [&](int d, int n) { return n < g.N ? Sin[d * g.N + n] : 0.f; }, As,
                          Bs);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int q = ty + 16 * i, n = tx + 16 * j;
      if (q < real && n < g.N) dC[(static_cast<long long>(b) * g.S + ch.s0 + q) * g.N + n] =
          acc[i][j];
    }

  // dB = Mᵀ·C + Σ_h exp(cs_end − cs_k) u_k R
  zero(acc);
  gemm<NJ, false, false>(acc, kL, [&](int k, int q) { return Ms[q * kLZ + k]; },
                         [&](int q, int n) { return ch.cm(Cm, q, n); }, As, Bs);
  for (int h = 0; h < g.H; ++h) {
    head(h);
    if (tid < kL) sc[tid] = lexp(csS[real - 1], csS[tid]);
    const float* Rc = R + (bc * g.H + h) * hdN;
    gemm<NJ, true, false>(
        acc, g.hd, [&](int k, int d) { return sc[k] * dtS[k] * ch.x(x, h, k, d); },
        [&](int d, int n) { return n < g.N ? Rc[d * g.N + n] : 0.f; }, As, Bs);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = ty + 16 * i, n = tx + 16 * j;
      if (k < real && n < g.N) dB[(static_cast<long long>(b) * g.S + ch.s0 + k) * g.N + n] =
          acc[i][j];
    }
}

// ---- 5. dA: the chunks' shares, summed over (b, chunk) in order -------------
__global__ void ssd_bwd_da_kernel(const double* __restrict__ part, float* __restrict__ dA,
                                  const Geometry g) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= g.H) return;
  double s = 0.0;
  for (long long bc = 0; bc < static_cast<long long>(g.Bsz) * g.nc; ++bc) s += part[bc * g.H + h];
  dA[h] = static_cast<float>(s);
}

// (a double cs takes two floats' room)
constexpr long long e_floats() { return gemm_floats() + 3 * kL; }
constexpr long long head_floats() { return gemm_floats() + kL * kLZ + 9 * kL + kThreads; }
constexpr long long bc_floats() { return gemm_floats() + kL * kLZ + 4 * kL; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(floats * sizeof(float)));
}

int padded(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <int HJ, int NJ>
int run(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
        const float* dy, const float* dstate, const Geometry& g, const Work& w, float* R,
        double* part, float* dx, float* ddt, float* dA, float* dB, float* dC, cudaStream_t s,
        int* launched) {
  cudaError_t e;
  if ((e = allow_smem(ssd_bwd_e_kernel<NJ>, e_floats())) != cudaSuccess) return e;
  if ((e = allow_smem(ssd_bwd_head_kernel<HJ>, head_floats())) != cudaSuccess) return e;
  if ((e = allow_smem(ssd_bwd_bc_kernel<NJ>, bc_floats())) != cudaSuccess) return e;
  const dim3 chunks(g.nc, g.H, g.Bsz);
  ssd_bwd_e_kernel<NJ><<<chunks, kThreads, e_floats() * sizeof(float), s>>>(dt, A, Cm, dy, g,
                                                                            w, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  const long long total = static_cast<long long>(g.Bsz) * g.H * g.hd * g.N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ssd_bwd_pass_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), kThreads, 0,
                        s>>>(g, w, R, dstate);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  ssd_bwd_head_kernel<HJ><<<chunks, kThreads, head_floats() * sizeof(float), s>>>(
      x, dt, A, Bm, Cm, dy, g, w, R, dx, ddt, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  ssd_bwd_bc_kernel<NJ><<<dim3(g.nc, g.Bsz), kThreads, bc_floats() * sizeof(float), s>>>(
      x, dt, Bm, Cm, dy, g, w, R, dB, dC);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  ssd_bwd_da_kernel<<<(g.H + 127) / 128, 128, 0, s>>>(part, dA, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return 0;
}

template <int HJ>
int run_n(int NP, const float* x, const float* dt, const float* A, const float* Bm,
          const float* Cm, const float* dy, const float* dstate, const Geometry& g,
          const Work& w, float* R, double* part, float* dx, float* ddt, float* dA, float* dB,
          float* dC, cudaStream_t s, int* launched) {
  if (NP == 32)
    return run<HJ, 2>(x, dt, A, Bm, Cm, dy, dstate, g, w, R, part, dx, ddt, dA, dB, dC, s,
                      launched);
  if (NP == 64)
    return run<HJ, 4>(x, dt, A, Bm, Cm, dy, dstate, g, w, R, part, dx, ddt, dA, dB, dC, s,
                      launched);
  return run<HJ, 8>(x, dt, A, Bm, Cm, dy, dstate, g, w, R, part, dx, ddt, dA, dB, dC, s,
                    launched);
}

bool geometry(Geometry& g, int Bsz, int S, int H, int hd, int N, const long long* strides) {
  g.Bsz = Bsz; g.S = S; g.H = H; g.hd = hd; g.N = N;
  g.nc = (S + kL - 1) / kL;
  for (int i = 0; i < 4; ++i) g.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    g.dts[i] = strides[4 + i];
    g.bs[i] = strides[7 + i];
    g.cs[i] = strides[10 + i];
  }
  return padded(hd) <= kMaxPad && hd <= kMaxPad && N <= kMaxPad;
}

}  // namespace

// Float32 elements of the forward's workspace this entry reads (must equal
// ssd_scan_workspace_floats for the same sizes), and of its own: the state
// gradients (Bsz, nc, H, hd, N), then in double the chunks' shares of dA
// (Bsz, nc, H) and cs (Bsz, nc, H, kL), then the chunks' decays (Bsz, nc, H).
extern "C" long long ssd_scan_bwd_forward_workspace_floats(int Bsz, int S, int H, int hd,
                                                           int N) {
  Geometry g;
  const long long zeros[13] = {};
  geometry(g, Bsz, S, H, hd, N, zeros);
  return ws_floats(g, nullptr, nullptr);
}

extern "C" long long ssd_scan_bwd_workspace_floats(int Bsz, int S, int H, int hd, int N) {
  const long long bc = static_cast<long long>(Bsz) * ((S + kL - 1) / kL);
  // the state gradients, rounded up to 8 bytes, then the doubles
  return (bc * H * static_cast<long long>(hd) * N + 1) / 2 * 2 + 2 * bc * H * (1 + kL) + bc * H;
}

// x, dt, A, Bm, Cm and strides as ssd_scan_f32 takes them; fws: the forward
// call's workspace on the same inputs; dy: contiguous (Bsz, S, H, hd);
// dstate: contiguous (Bsz, H, hd, N) or null (zero); ws:
// ssd_scan_bwd_workspace_floats(...) float32 elements.  Outputs, contiguous
// float32: dx (Bsz, S, H, hd), ddt (Bsz, S, H), dA (H,), dB and dC
// (Bsz, S, N).  *launched: the CUDA launches made (5 when S > 0).  Returns
// the first CUDA error, or cudaErrorInvalidValue without a launch for hd or
// N above 128.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* dy, const void* dstate,
                                const void* fws, void* ws, void* dx, void* ddt, void* dA,
                                void* dB, void* dC, int Bsz, int S, int H, int hd, int N,
                                const long long* strides, void* stream, int* launched) {
  *launched = 0;
  if (Bsz == 0 || H == 0 || hd == 0 || N == 0 || S == 0) return static_cast<int>(cudaSuccess);
  Geometry g;
  if (!geometry(g, Bsz, S, H, hd, N, strides) || Bsz > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Work w;
  ws_floats(g, &w, static_cast<const float*>(fws));
  float* R = static_cast<float*>(ws);
  double* part = reinterpret_cast<double*>(
      R + (static_cast<long long>(Bsz) * g.nc * H * static_cast<long long>(hd) * N + 1) / 2 * 2);
  w.csd = part + static_cast<long long>(Bsz) * g.nc * H;
  w.decd = reinterpret_cast<float*>(w.csd + static_cast<long long>(Bsz) * g.nc * H * kL);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(dstate);
  float* dxf = static_cast<float*>(dx);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* dBf = static_cast<float*>(dB);
  float* dCf = static_cast<float*>(dC);
  const int HP = padded(hd), NP = padded(N);
  int e;
  if (HP == 32)
    e = run_n<2>(NP, xf, dtf, Af, Bf, Cf, dyf, dsf, g, w, R, part, dxf, ddtf, dAf, dBf, dCf, s,
                 launched);
  else if (HP == 64)
    e = run_n<4>(NP, xf, dtf, Af, Bf, Cf, dyf, dsf, g, w, R, part, dxf, ddtf, dAf, dBf, dCf, s,
                 launched);
  else
    e = run_n<8>(NP, xf, dtf, Af, Bf, Cf, dyf, dsf, g, w, R, part, dxf, ddtf, dAf, dBf, dCf, s,
                 launched);
  return e;
}

// Registers a thread and local (spill) bytes a thread of each launch's
// template at padded hd and N = 128 (the widest), as
// [e, head, bc] x [regs, local bytes].  Returns a CUDA error.
extern "C" int ssd_scan_bwd_attributes(int* out) {
  const void* fns[3] = {reinterpret_cast<const void*>(ssd_bwd_e_kernel<8>),
                        reinterpret_cast<const void*>(ssd_bwd_head_kernel<8>),
                        reinterpret_cast<const void*>(ssd_bwd_bc_kernel<8>)};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = static_cast<int>(a.localSizeBytes);
  }
  return 0;
}
