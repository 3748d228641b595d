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
//      order: R_c over it in place, from the final state's gradient (or 0),
//      four elements a thread and 16 chunks' loads in flight, as the
//      forward's pass;
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
//
// Every product (launches 1, 3 and 4) is a 128-row tile with 256 threads on
// the tensor cores, as kernel 6's (ssd_scan.cu, helpers shared through
// tf32_mma.cuh): mma.sync m16n8k8 TF32, each operand split as hi = tf32(a),
// lo = a − hi and a·b taken as lo·hi + hi·lo + hi·hi with float32
// accumulation; a warp pair takes row tiles p and 7 − p (a causal product's
// work evened out), its warps alternate 32-column groups, two row tiles
// sharing each B fragment (`mma3x2`).  One TF32 product keeps ~3 digits: it
// leaves the backward's gate (1e-4·max|f64|) by 9–18× in the CPU emulation
// (ssd_scan.ssd_scan_bwd_emulated, tests/test_torch_ssd_scan.py), where the
// split stays within 0.07 of it.  Each product stages its two operands whole
// (K ≤ 128) into shared memory by 16-byte cp.async where the rows allow
// (4-byte copies otherwise), scales rows there where an operand is formed
// (u = dt·x, exp(cs_q)·dy, P = L∘C·Bᵀ, ...), then multiplies: launch 3 runs
// its four products in turn through one 104 KB region (at hd 64, N 128),
// launches 1 and 3 run two blocks an SM with 8 warps, launch 4 one with 16
// (its M = Σ_h L∘G in registers, then a 66 KB copy in shared memory for
// M·B and Mᵀ·C).  Row
// sums of a product's tile (dcs, w, x·du) reduce over a fragment row's
// quad, then over the two warps of its pair through shared memory; Z's
// column sums over the eight row lanes, then over the four pairs — each in
// a fixed order.  The exponentials, masks and the reverse cumsum stay on the
// CUDA cores.
//
// Bound on an H100: at mamba2-370m's training shapes (B 8, S 4096, H 32,
// hd 64, N 128) the gradient is ~1.2e11 float32 operations at kL = 128
// (chip_smoke.ssd_bwd_ops_bytes counts them) against ~1.2 GB of inputs,
// saved states and outputs: operations, ~0.74 ms as three split TF32
// products on the tensor cores (the card's float32 peak), ~1.8 ms at the
// CUDA cores' 67 TFLOP/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kL = 128;          // positions a chunk (the forward's)
constexpr int kRT = kL / 16;     // 16-row tiles of a chunk
constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxPad = 128;     // largest padded hd and N
static_assert(kThreads == 32 * kTileWarps, "the staging helpers assume 8 warps");

struct Geometry {
  int Bsz, S, H, hd, N, HP, NP, nc;        // HP, NP: hd and N padded to multiples of 32
  long long xs[4], dts[3], bs[3], cs[3];   // element strides
  int vec;                                 // kVec* bits: 16-byte rows
};
// operands whose rows can be staged by 16-byte copies
constexpr int kVecX = 1, kVecB = 2, kVecC = 4, kVecSt = 8, kVecDy = 16;

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

int pad32(int n) { return (n + 31) / 32 * 32; }

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

// exp(a − b) of two cumulative decays: the difference in double, rounded once
__device__ __forceinline__ float lexp(double a, double b) {
  return expf(static_cast<float>(a - b));
}

// the sum of v over the 4 lanes that share a fragment row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows[r][0..cols) *= scale(r) for r < kL: a warp a row, four columns a lane
// (cols a multiple of 4, at most 128; ld a multiple of 4); kWarps: the block's
template <int kWarps = kTileWarps, typename F>
__device__ __forceinline__ void scale_rows(float* rows, int ld, int cols, F scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kL; r += kWarps) {
    if (lane * 4 >= cols) continue;
    const float s = scale(r);
    float4* p = reinterpret_cast<float4*>(rows + r * ld + lane * 4);
    const float4 v = *p;
    *p = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
  }
}

// A warp's share of a 128-row product tile (the forward's ssd_out_kernel
// layout): warp pair p — kPairWarps warps — takes row tiles p and kRT − 1 − p
// (a causal product's work evened out), its warps alternate 32-column
// groups, and acc[side][gi][j][e] is row (side ? r1 : r0) + g + 8(e >> 1),
// column 32·cg + 8j + 2t + (e & 1) of column group cg = cw + kPairWarps·gi
// (mma.sync m16n8k8's fragment layout, lane = 4g + t).  Eight warps make
// pairs of two, sixteen of four.
template <int kPairWarps = 2>
struct Tile {
  int r0, r1, g, t, cw;
  __device__ Tile() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r0 = (warp / kPairWarps) * 16;
    r1 = (kRT - 1 - warp / kPairWarps) * 16;
    g = lane >> 2;
    t = lane & 3;
    cw = warp % kPairWarps;
  }
  __device__ int cg(int gi) const { return cw + kPairWarps * gi; }
  __device__ int row(int side, int e) const { return (side ? r1 : r0) + g + 8 * (e >> 1); }
  __device__ int col(int gi, int j, int e) const { return 32 * cg(gi) + 8 * j + 2 * t + (e & 1); }
};

// ---- 1. per (b, h, chunk): cs in double; Σ_q exp(cs_q) dy_qᵀ C_q ------------
__host__ __device__ long long e_floats(int HP, int NP) {
  return 1LL * kL * (HP + 8) + 1LL * kL * (NP + 8) + 3 * kL;
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_e_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ Cm, const float* __restrict__ dy, const Geometry g,
                 const Work w, float* __restrict__ R) {
  extern __shared__ __align__(16) float smem[];
  const int HP = g.HP, NP = g.NP, LY = HP + 8, LC = NP + 8;
  float* ys = smem;                                        // [kL][LY] dy rows, then × exp(cs_q)
  float* cS = ys + kL * LY;                                // [kL][LC] C rows
  double* csS = reinterpret_cast<double*>(cS + kL * LC);   // [kL] cs
  float* xS = reinterpret_cast<float*>(csS + kL);          // [kL] exp(cs_q)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, s0 = c * kL, tid = threadIdx.x;
  const int real = min(kL, g.S - s0);
  const long long bch = (static_cast<long long>(b) * g.nc + c) * g.H + h;
  stage(ys, LY, dy + ((static_cast<long long>(b) * g.S + s0) * g.H + h) * g.hd,
        static_cast<long long>(g.H) * g.hd, 1, kL, real, HP, g.hd, g.vec & kVecDy, false);
  stage(cS, LC, Cm + b * g.cs[0] + s0 * g.cs[1], g.cs[1], g.cs[2], kL, real, NP, g.N,
        g.vec & kVecC, false);
  // cs = cumsum(dt·A) in order, in double (dt·A of float32 values is exact
  // there); constant past the chunk's last real position, where dt is 0
  if (tid < kL)
    csS[tid] = tid < real ? static_cast<double>(
                                dt[b * g.dts[0] + (s0 + tid) * g.dts[1] + h * g.dts[2]]) * A[h]
                          : 0.0;
  __syncthreads();
  if (tid == 0) {
    double run = 0.0;
    for (int t = 0; t < kL; ++t) csS[t] = run += csS[t];
    w.decd[bch] = expf(static_cast<float>(csS[real - 1]));
  }
  __syncthreads();
  if (tid < kL) {
    w.csd[bch * kL + tid] = csS[tid];
    xS[tid] = expf(static_cast<float>(csS[tid]));
  }
  cp_async_wait_all();
  __syncthreads();
  scale_rows(ys, LY, HP, [&](int q) { return xS[q]; });
  __syncthreads();

  // E[d][n] = Σ_q ys[q][d] cS[q][n]: a warp owns 32 rows d x 32 columns n,
  // two row tiles sharing each B fragment (the forward's state kernel)
  const int warp = tid >> 5, groups = NP / 32, items = (HP / 32) * groups;
  float acc[2][2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int it = warp + i * kTileWarps;
    zero(acc[i][0]);
    zero(acc[i][1]);
    if (it >= items) continue;
    const int r0 = (it / groups) * 32, c0 = (it % groups) * 32;
    mma3x2<4, true, false>(acc[i][0], acc[i][1], ys, LY, cS, LC, r0, r0 + 16, c0, kL, kL);
  }
  __syncthreads();
  float* ot = smem;                                        // [HP][NP + 4]
  const int LO = NP + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int it = warp + i * kTileWarps;
    if (it >= items) continue;
    const int r0 = (it / groups) * 32, c0 = (it % groups) * 32;
    park(ot, LO, acc[i][0], acc[i][1], r0, r0 + 16, c0);
  }
  __syncthreads();
  unpark(R + bch * g.hd * g.N, g.N, ot, LO, g.hd, g.N, g.vec & kVecSt);
}

// ---- 2. per (b, h) state element: R_c in reverse chunk order ----------------
// V consecutive elements a thread; the loads of a group of kGroup chunks are
// issued before any store, so they are in flight together (ssd_scan.cu's pass).
constexpr int kGroup = 16;

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(const Geometry g, const Work w, float* __restrict__ R,
                    const float* __restrict__ dstate) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long per = static_cast<long long>(g.hd) * g.N / V;
  const long long total = static_cast<long long>(g.Bsz) * g.H * per;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long bh = e / per, r = e % per, b = bh / g.H, h = bh % g.H;
    Vec* base = reinterpret_cast<Vec*>(R) + (b * g.nc * g.H + h) * per + r;
    const long long step = static_cast<long long>(g.H) * per;   // one chunk
    const float* dec = w.decd + b * g.nc * g.H + h;
    float s[V];
    if (dstate != nullptr) {
      const Vec d0 = reinterpret_cast<const Vec*>(dstate)[e];
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = reinterpret_cast<const float*>(&d0)[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = 0.f;
    }
    for (int c1 = g.nc - 1; c1 >= 0; c1 -= kGroup) {
      Vec v[kGroup];
      float dv[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (c1 - j >= 0) {
          v[j] = base[(c1 - j) * step];
          dv[j] = dec[(c1 - j) * g.H];
        }
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (c1 - j >= 0) {
          const float* ec = reinterpret_cast<const float*>(&v[j]);
          Vec out;
          float* of = reinterpret_cast<float*>(&out);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            of[i] = s[i];                         // the gradient of the state after chunk c
            s[i] = fmaf(s[i], dv[j], ec[i]);
          }
          base[(c1 - j) * step] = out;
        }
    }
  }
}

// ---- 3. per (b, h, chunk): dx, ddt and the chunk's share of dA --------------
// The four products run in turn through one region of shared memory, each
// phase staging its two operands by cp.async.
__host__ __device__ long long head_region(int HP, int NP) {
  const long long a = 2LL * kL * (HP + 4);                        // dy, u
  const long long b = 1LL * (kL + HP) * (NP + 4);                 // C or B; S_in or R
  const long long d = 1LL * kL * (kL + 8) + 1LL * kL * (HP + 8);  // P; dy
  const long long m = a > b ? (a > d ? a : d) : (b > d ? b : d);
  return (m + 3) / 4 * 4;
}
__host__ __device__ long long head_floats(int HP, int NP) {
  return head_region(HP, NP) + 2 * kL + 7 * kL + 2 * kL + 4 * kL;
}

// GI: the column groups a warp takes of an hd-wide product (1 for hd ≤ 64, 2 up to 128)
template <int GI>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dy,
                    const Geometry g, const Work w, const float* __restrict__ R,
                    float* __restrict__ dx, float* __restrict__ ddt,
                    double* __restrict__ dA_part) {
  extern __shared__ __align__(16) float smem[];
  const int HP = g.HP, NP = g.NP;
  double* csS = reinterpret_cast<double*>(smem + head_region(HP, NP));   // cs
  float* dtS = reinterpret_cast<float*>(csS + kL);   // dt
  float* eS = dtS + kL;               // exp(cs_end − cs_k)
  float* xS = eS + kL;                // exp(cs_q)
  float* dcsS = xS + kL;              // dcs, built up term by term
  float* colS = dcsS + kL;            // Z's column sums
  float* wS = colS + kL;              // u_k·(exp(cs_end − cs_k) R B_k)
  float* xduS = wS + kL;              // x_k·du_k
  float* rowp = xduS + kL;            // [2][kL] a row's sums from the two warps of its pair
  float* colp = rowp + 2 * kL;        // [4][kL] a column's sums from the four pairs; then
  float* red = colp;                  // [kThreads] <R, S_in>'s partial sums
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, s0 = c * kL, tid = threadIdx.x;
  const int real = min(kL, g.S - s0);
  const long long bch = (static_cast<long long>(b) * g.nc + c) * g.H + h;
  const long long hdN = static_cast<long long>(g.hd) * g.N;
  const long long dy_row = static_cast<long long>(g.H) * g.hd;
  const float* dyb = dy + ((static_cast<long long>(b) * g.S + s0) * g.H + h) * g.hd;
  const float* xb = x + b * g.xs[0] + s0 * g.xs[1] + h * g.xs[2];
  const float* cb = w.cb + (static_cast<long long>(b) * g.nc + c) * kL * kL;
  const float* Sin = w.st + bch * hdN;
  const float* Rc = R + bch * hdN;
  auto xv = [&](int t, int d) {
    return t < real && d < g.hd ? xb[t * g.xs[1] + d * g.xs[3]] : 0.f;
  };
  auto dyv = [&](int t, int d) { return t < real && d < g.hd ? dyb[t * dy_row + d] : 0.f; };
  const Tile<> T;
  const bool lead = T.t == 0;         // the lane of a fragment row's quad that writes its sum
  const int hgroups = HP / 32;
  // a warp's sums of its fragment rows, into rowp
  auto put_rows = [&](float (&part)[2][2]) {
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float s = quad_sum(part[side][half]);
        if (lead) rowp[T.cw * kL + T.row(side, 2 * half)] = s;
      }
  };

  if (tid < kL) {
    csS[tid] = w.csd[bch * kL + tid];
    dtS[tid] = tid < real ? dt[b * g.dts[0] + (s0 + tid) * g.dts[1] + h * g.dts[2]] : 0.f;
  }
  // phase A: G = dy·uᵀ (u = dt·x); Z = L∘(C·Bᵀ)∘G below the diagonal (its
  // diagonal cancels in dcs): row sums +Z to the query side, column sums −Z
  // to the key side
  {
    const int LA = HP + 4;
    float* dyS = smem;                // [kL][LA]
    float* uS = smem + kL * LA;       // [kL][LA]
    stage(dyS, LA, dyb, dy_row, 1, kL, real, HP, g.hd, g.vec & kVecDy, false);
    stage(uS, LA, xb, g.xs[1], g.xs[3], kL, real, HP, g.hd, g.vec & kVecX, false);
    __syncthreads();
    const double cs_end = csS[real - 1];
    if (tid < kL) {
      eS[tid] = expf(static_cast<float>(cs_end - csS[tid]));
      xS[tid] = expf(static_cast<float>(csS[tid]));
    }
    cp_async_wait_all();
    __syncthreads();
    scale_rows(uS, LA, HP, [&](int k) { return dtS[k]; });
    __syncthreads();
    float rp[2][2] = {}, cp[2][4][2] = {};
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      float G[2][4][4];
      zero(G[0]);
      zero(G[1]);
      mma3x2<4, false, true>(G[0], G[1], dyS, LA, uS, LA, T.r0, T.r1, 32 * T.cg(gi), HP, HP);
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = T.row(side, e), k = T.col(gi, j, e);
            const float z = q > k ? lexp(csS[q], csS[k]) * cb[q * kL + k] * G[side][j][e] : 0.f;
            rp[side][e >> 1] += z;
            cp[gi][j][e & 1] += z;
          }
    }
    put_rows(rp);
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          float s = cp[gi][j][par];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (T.g == 0) colp[(T.r0 / 16) * kL + T.col(gi, j, par)] = s;
        }
    __syncthreads();
    if (tid < kL) {
      dcsS[tid] = rowp[tid] + rowp[kL + tid];
      colS[tid] = ((colp[tid] + colp[kL + tid]) + colp[2 * kL + tid]) + colp[3 * kL + tid];
    }
  }

  // phase B: the read-out of the entering state, dcs_q += exp(cs_q)·dy_q·(S_in C_q)
  const int LC = NP + 4;
  {
    float* cS = smem;                 // [kL][LC] C rows
    float* sS = smem + kL * LC;       // [HP][LC] S_in[d][n]
    __syncthreads();
    stage(cS, LC, Cm + b * g.cs[0] + s0 * g.cs[1], g.cs[1], g.cs[2], kL, real, NP, g.N,
          g.vec & kVecC, false);
    stage(sS, LC, Sin, g.N, 1, HP, g.hd, NP, g.N, g.vec & kVecSt, false);
    cp_async_wait_all();
    __syncthreads();
    float rp[2][2] = {};
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
      if (T.cg(gi) >= hgroups) continue;
      float Y[2][4][4];
      zero(Y[0]);
      zero(Y[1]);
      mma3x2<4, false, true>(Y[0], Y[1], cS, LC, sS, LC, T.r0, T.r1, 32 * T.cg(gi), NP, NP);
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rp[side][e >> 1] =
                fmaf(dyv(T.row(side, e), T.col(gi, j, e)), Y[side][j][e], rp[side][e >> 1]);
    }
    put_rows(rp);
    __syncthreads();
    if (tid < kL) dcsS[tid] = fmaf(xS[tid], rowp[tid] + rowp[kL + tid], dcsS[tid]);
  }

  // phase C: du's state term exp(cs_end − cs_k)·R B_k, and w_k = u_k·that
  float du[2][GI][4][4];
#pragma unroll
  for (int side = 0; side < 2; ++side)
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) zero(du[side][gi]);
  {
    float* bS = smem;                 // [kL][LC] B rows
    float* rS = smem + kL * LC;       // [HP][LC] R[d][n]
    stage(bS, LC, Bm + b * g.bs[0] + s0 * g.bs[1], g.bs[1], g.bs[2], kL, real, NP, g.N,
          g.vec & kVecB, false);
    stage(rS, LC, Rc, g.N, 1, HP, g.hd, NP, g.N, g.vec & kVecSt, false);
    cp_async_wait_all();
    __syncthreads();
    float rp[2][2] = {};
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
      if (T.cg(gi) >= hgroups) continue;
      mma3x2<4, false, true>(du[0][gi], du[1][gi], bS, LC, rS, LC, T.r0, T.r1, 32 * T.cg(gi),
                             NP, NP);
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = T.row(side, e);
            du[side][gi][j][e] *= eS[k];
            rp[side][e >> 1] = fmaf(dtS[k] * xv(k, T.col(gi, j, e)), du[side][gi][j][e],
                                    rp[side][e >> 1]);
          }
    }
    put_rows(rp);
    __syncthreads();
    if (tid < kL) wS[tid] = rowp[tid] + rowp[kL + tid];
  }

  // phase D: du += Pᵀ·dy with P = L∘(C·Bᵀ) where a key can be seen (q ≥ k);
  // then dx = dt·du and x·du
  {
    const int LP = kL + 8, LY = HP + 8;
    float* pS = smem;                 // [kL][LP] C·Bᵀ, then P, as [q][k]
    float* yS = smem + kL * LP;       // [kL][LY] dy rows
    stage(pS, LP, cb, kL, 1, kL, kL, kL, kL, true, false);
    stage(yS, LY, dyb, dy_row, 1, kL, real, HP, g.hd, g.vec & kVecDy, false);
    cp_async_wait_all();
    __syncthreads();
    for (int q = tid >> 5; q < kL; q += kTileWarps)
      for (int k = tid & 31; k < kL; k += 32)
        pS[q * LP + k] = k <= q ? lexp(csS[q], csS[k]) * pS[q * LP + k] : 0.f;
    __syncthreads();
    float rp[2][2] = {};
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {
      if (T.cg(gi) >= hgroups) continue;
      mma3x2<4, true, false>(du[0][gi], du[1][gi], pS, LP, yS, LY, T.r0, T.r1, 32 * T.cg(gi),
                             kL, kL);
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = T.row(side, e), d = T.col(gi, j, e);
            rp[side][e >> 1] = fmaf(xv(k, d), du[side][gi][j][e], rp[side][e >> 1]);
            if (k < real && d < g.hd)
              dx[((static_cast<long long>(b) * g.S + s0 + k) * g.H + h) * g.hd + d] =
                  dtS[k] * du[side][gi][j][e];
          }
    }
    put_rows(rp);
  }

  // <R, S_in>, for the chunk decay's own term: 16-byte loads where the rows
  // allow, several in flight a thread
  float part = 0.f;
  if (g.vec & kVecSt) {
    const float4* r4 = reinterpret_cast<const float4*>(Rc);
    const float4* s4 = reinterpret_cast<const float4*>(Sin);
#pragma unroll 4
    for (long long e = tid; e < hdN / 4; e += kThreads) {
      const float4 a = r4[e], v = s4[e];
      part = fmaf(a.x, v.x, fmaf(a.y, v.y, fmaf(a.z, v.z, fmaf(a.w, v.w, part))));
    }
  } else {
#pragma unroll 4
    for (long long e = tid; e < hdN; e += kThreads) part = fmaf(Rc[e], Sin[e], part);
  }
  red[tid] = part;
  __syncthreads();
  if (tid < kL) xduS[tid] = rowp[tid] + rowp[kL + tid];
  __syncthreads();
  if (tid < 32) {                     // warp 0: the sums of red and w, in a fixed order
    float rs = 0.f, wsum = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) rs += red[32 * i + tid];
#pragma unroll
    for (int i = 0; i < kL / 32; ++i) wsum += 32 * i + tid < real ? wS[32 * i + tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
      wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    }
    if (tid == 0) red[0] = fmaf(w.decd[bch], rs, wsum);
  }
  __syncthreads();
  if (tid == 0) {
    const float dcs_end = red[0];
    const float a_h = A[h];
    // the reverse cumsum and dA's share run in double: dA sums d(dt·A)
    // over every position, with cancellation between the terms
    double run = 0.0, dAp = 0.0;
    for (int t = real - 1; t >= 0; --t) {
      float dcs = dcsS[t] - wS[t] - colS[t];
      if (t == real - 1) dcs += dcs_end;
      run += dcs;                                 // d(dt·A)_t = Σ_{t' ≥ t} dcs_t'
      ddt[(static_cast<long long>(b) * g.S + s0 + t) * g.H + h] =
          fmaf(a_h, static_cast<float>(run), xduS[t]);
      dAp += static_cast<double>(dtS[t]) * run;
    }
    dA_part[bch] = dAp;
  }
}

// ---- 4. per (b, chunk): dC and dB, summed over the heads in order -----------
// Sixteen warps: a (b, chunk) block is one of few (one an SM), and its
// products and their epilogues run one after another, so more warps hide
// more of each one's latency; each warp takes one 32-column group.
constexpr int kBcWarps = 16;
__host__ __device__ long long bc_region(int HP, int NP) {
  const long long a = 2LL * kL * (HP + 4);                        // dy, u
  const long long b = 1LL * kL * (NP + 8);                        // B or C
  const long long d = 1LL * kL * (HP + 4) + 1LL * HP * (NP + 8);  // dy or u; S_in or R
  const long long m = a > b ? (a > d ? a : d) : (b > d ? b : d);
  return (m + 3) / 4 * 4;
}
__host__ __device__ long long bc_floats(int HP, int NP) {
  return 1LL * kL * (kL + 4) + bc_region(HP, NP) + 2 * kL + kL;
}

__global__ void __launch_bounds__(32 * kBcWarps, 1)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ dy, const Geometry g, const Work w,
                  const float* __restrict__ R, float* __restrict__ dB,
                  float* __restrict__ dC) {
  extern __shared__ __align__(16) float smem[];
  const int HP = g.HP, NP = g.NP, LM = kL + 4, LA = HP + 4, LB = NP + 8;
  float* Ms = smem;                                   // [kL][LM] Σ_h L∘(dy·uᵀ), [q][k]
  float* U = Ms + kL * LM;                            // the operands' region
  double* csS = reinterpret_cast<double*>(U + bc_region(HP, NP));
  float* dtS = reinterpret_cast<float*>(csS + kL);
  const int c = blockIdx.x, b = blockIdx.y, s0 = c * kL, tid = threadIdx.x;
  const int real = min(kL, g.S - s0);
  const long long bc = static_cast<long long>(b) * g.nc + c;
  const long long hdN = static_cast<long long>(g.hd) * g.N;
  const long long dy_row = static_cast<long long>(g.H) * g.hd;
  const Tile<kBcWarps / 4> T;
  const int ngroups = NP / 32;
  // after the last head's operands are consumed: a head's cs and dt, its dy
  // (or x) rows into U as [kL][LA], and into U + kL·LA its x rows ([kL][LA])
  // or a (HP x N) state (S_in or R, as [HP][LB]); then wait for them
  auto stage_head = [&](int h, bool x_first, bool x_second, const float* state) {
    __syncthreads();
    const float* xh = x + b * g.xs[0] + s0 * g.xs[1] + h * g.xs[2];
    const float* dyh = dy + ((static_cast<long long>(b) * g.S + s0) * g.H + h) * g.hd;
    if (x_first)
      stage<kBcWarps>(U, LA, xh, g.xs[1], g.xs[3], kL, real, HP, g.hd, g.vec & kVecX,
                      false);
    else
      stage<kBcWarps>(U, LA, dyh, dy_row, 1, kL, real, HP, g.hd, g.vec & kVecDy, false);
    if (x_second)
      stage<kBcWarps>(U + kL * LA, LA, xh, g.xs[1], g.xs[3], kL, real, HP, g.hd,
                      g.vec & kVecX, false);
    else if (state != nullptr)
      stage<kBcWarps>(U + kL * LA, LB, state, g.N, 1, HP, g.hd, NP, g.N, g.vec & kVecSt,
                      false);
    if (tid < kL) {
      csS[tid] = w.csd[(bc * g.H + h) * kL + tid];
      dtS[tid] = tid < real ? dt[b * g.dts[0] + (s0 + tid) * g.dts[1] + h * g.dts[2]] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
  };
  const int cg = T.cg(0);             // the warp's 32-column group
  auto store = [&](float* out, float (&acc)[2][4][4]) {
    if (cg >= ngroups) return;
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = T.row(side, e), n = T.col(0, j, e);
          if (r < real && n < g.N)
            out[(static_cast<long long>(b) * g.S + s0 + r) * g.N + n] = acc[side][j][e];
        }
  };

  // M = Σ_h L∘(dy·uᵀ) where a key can be seen (q ≥ k), the heads in order
  {
    float M[2][4][4];
    zero(M[0]);
    zero(M[1]);
    float* uS = U + kL * LA;          // [kL][LA] u = dt·x
    for (int h = 0; h < g.H; ++h) {
      stage_head(h, false, true, nullptr);
      scale_rows<kBcWarps>(uS, LA, HP, [&](int k) { return dtS[k]; });
      __syncthreads();
      float G[2][4][4];
      zero(G[0]);
      zero(G[1]);
      mma3x2<4, false, true>(G[0], G[1], U, LA, uS, LA, T.r0, T.r1, 32 * cg, HP, HP);
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = T.row(side, e), k = T.col(0, j, e);
            if (q >= k) M[side][j][e] = fmaf(lexp(csS[q], csS[k]), G[side][j][e], M[side][j][e]);
          }
    }
    park(Ms, LM, M[0], M[1], T.r0, T.r1, 32 * cg);
  }

  float acc[2][4][4];
  // dC = M·B + Σ_h exp(cs_q) dy_q S_in
  zero(acc[0]);
  zero(acc[1]);
  __syncthreads();
  stage<kBcWarps>(U, LB, Bm + b * g.bs[0] + s0 * g.bs[1], g.bs[1], g.bs[2], kL, real, NP, g.N,
                  g.vec & kVecB, false);
  cp_async_wait_all();
  __syncthreads();
  if (cg < ngroups)
    mma3x2<4, false, false>(acc[0], acc[1], Ms, LM, U, LB, T.r0, T.r1, 32 * cg, T.r0 + 16,
                            T.r1 + 16);
  for (int h = 0; h < g.H; ++h) {
    stage_head(h, false, false, w.st + (bc * g.H + h) * hdN);
    scale_rows<kBcWarps>(U, LA, HP,
                         [&](int q) { return expf(static_cast<float>(csS[q])); });
    __syncthreads();
    if (cg < ngroups)
      mma3x2<4, false, false>(acc[0], acc[1], U, LA, U + kL * LA, LB, T.r0, T.r1, 32 * cg, HP,
                              HP);
  }
  store(dC, acc);

  // dB = Mᵀ·C + Σ_h exp(cs_end − cs_k) u_k R
  zero(acc[0]);
  zero(acc[1]);
  __syncthreads();
  stage<kBcWarps>(U, LB, Cm + b * g.cs[0] + s0 * g.cs[1], g.cs[1], g.cs[2], kL, real, NP, g.N,
                  g.vec & kVecC, false);
  cp_async_wait_all();
  __syncthreads();
  if (cg < ngroups)
    mma3x2<4, true, false>(acc[0], acc[1], Ms, LM, U, LB, T.r0, T.r1, 32 * cg, kL, kL);
  for (int h = 0; h < g.H; ++h) {
    stage_head(h, true, false, R + (bc * g.H + h) * hdN);
    scale_rows<kBcWarps>(U, LA, HP,
                         [&](int k) { return lexp(csS[real - 1], csS[k]) * dtS[k]; });
    __syncthreads();
    if (cg < ngroups)
      mma3x2<4, false, false>(acc[0], acc[1], U, LA, U + kL * LA, LB, T.r0, T.r1, 32 * cg, HP,
                              HP);
  }
  store(dB, acc);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(floats * sizeof(float)));
}

int run(const float* x, const float* dt, const float* A, const float* Bm, const float* Cm,
        const float* dy, const float* dstate, const Geometry& g, const Work& w, float* R,
        double* part, float* dx, float* ddt, float* dA, float* dB, float* dC, cudaStream_t s,
        int* launched) {
  const long long f1 = e_floats(g.HP, g.NP), f3 = head_floats(g.HP, g.NP),
                  f4 = bc_floats(g.HP, g.NP);
  cudaError_t e;
  if ((e = allow_smem(ssd_bwd_e_kernel, f1)) != cudaSuccess) return e;
  auto head = g.HP <= 64 ? ssd_bwd_head_kernel<1> : ssd_bwd_head_kernel<2>;
  if ((e = allow_smem(head, f3)) != cudaSuccess) return e;
  if ((e = allow_smem(ssd_bwd_bc_kernel, f4)) != cudaSuccess) return e;
  const dim3 chunks(g.nc, g.H, g.Bsz);
  ssd_bwd_e_kernel<<<chunks, kThreads, f1 * sizeof(float), s>>>(dt, A, Cm, dy, g, w, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  const int v = (static_cast<long long>(g.hd) * g.N) % 4 == 0 ? 4 : 1;
  const long long total = static_cast<long long>(g.Bsz) * g.H * g.hd * g.N / v;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  if (v == 4)
    ssd_bwd_pass_kernel<4><<<grid, kThreads, 0, s>>>(g, w, R, dstate);
  else
    ssd_bwd_pass_kernel<1><<<grid, kThreads, 0, s>>>(g, w, R, dstate);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  head<<<chunks, kThreads, f3 * sizeof(float), s>>>(x, dt, A, Bm, Cm, dy, g, w, R, dx, ddt, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  ssd_bwd_bc_kernel<<<dim3(g.nc, g.Bsz), 32 * kBcWarps, f4 * sizeof(float), s>>>(
      x, dt, Bm, Cm, dy, g, w, R, dB, dC);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  ssd_bwd_da_kernel<<<(g.H + 127) / 128, 128, 0, s>>>(part, dA, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return 0;
}

bool geometry(Geometry& g, int Bsz, int S, int H, int hd, int N, const long long* strides) {
  g.Bsz = Bsz; g.S = S; g.H = H; g.hd = hd; g.N = N;
  g.HP = pad32(hd);
  g.NP = pad32(N);
  g.nc = (S + kL - 1) / kL;
  for (int i = 0; i < 4; ++i) g.xs[i] = strides[i];
  for (int i = 0; i < 3; ++i) {
    g.dts[i] = strides[4 + i];
    g.bs[i] = strides[7 + i];
    g.cs[i] = strides[10 + i];
  }
  g.vec = 0;
  return g.HP <= kMaxPad && g.NP <= kMaxPad;
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
  auto rows16 = [](const void* p, long long s_b, long long s_row, long long s_col) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s_col == 1 && s_b % 4 == 0 &&
           s_row % 4 == 0;
  };
  g.vec = (rows16(x, g.xs[0], g.xs[1], g.xs[3]) && g.xs[2] % 4 == 0 ? kVecX : 0) |
          (rows16(Bm, g.bs[0], g.bs[1], g.bs[2]) ? kVecB : 0) |
          (rows16(Cm, g.cs[0], g.cs[1], g.cs[2]) ? kVecC : 0) | (N % 4 == 0 ? kVecSt : 0) |
          (hd % 4 == 0 ? kVecDy : 0);
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
  return run(xf, dtf, Af, Bf, Cf, dyf, dsf, g, w, R, part, dxf, ddtf, dAf, dBf, dCf, s, launched);
}

// Registers a thread and local (spill) bytes a thread of the launches that
// stage products (launch 3 at hd ≤ 64, the train path's), as [e, head, bc]
// x [regs, local bytes].  Returns a CUDA error.
extern "C" int ssd_scan_bwd_attributes(int* out) {
  const void* fns[3] = {reinterpret_cast<const void*>(ssd_bwd_e_kernel),
                        reinterpret_cast<const void*>(ssd_bwd_head_kernel<1>),
                        reinterpret_cast<const void*>(ssd_bwd_bc_kernel)};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = static_cast<int>(a.localSizeBytes);
  }
  return 0;
}
