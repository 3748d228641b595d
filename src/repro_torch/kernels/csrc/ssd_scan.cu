// Mamba2 SSD (state-space duality) scan, chunk-parallel on the tensor cores,
// with the final state.
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
// group).  y is a contiguous (B, S, H, hd) float32 array, the state a
// contiguous (B, H, hd, N) one.
//
// The structure of Mamba2's own SSD (Dao & Gu 2024), in chunks of kL = 128
// positions (the kernel's own chunk length; it changes only the rounding),
// as four launches behind the one C entry point:
//   1. ssd_prep_kernel, per (b, chunk): the in-chunk cumulative log-decay of
//      every head, as one thread's running sum per head (in order, as the
//      reference's cumsum: a tree scan would round neighbouring sums apart
//      and exp(cs_q − cs_k) of large |cs| would carry that), the chunk's
//      decay exp(cs_end) per head, and C·Bᵀ once for all heads (the causal
//      half);
//   2. ssd_state_kernel, per (b, h, chunk) in parallel: the chunk's own state
//      Σ_k (exp(cs_end − cs_k) dt_k B_k) ⊗ x_k;
//   3. ssd_pass_kernel, per (b, h) state element, in order over chunks: the
//      state entering each chunk, s ← exp(cs_end)·s + state_chunk (the
//      update of the sequential kernel, rounded the same way), written over
//      the chunk state; the last s is the final state;
//   4. ssd_out_kernel, per (b, h, chunk) in parallel:
//      y_q = exp(cs_q) C_q·s_in + Σ_{k ≤ q} M[q][k] x_k with
//      M[q][k] = (C_q·B_k) exp(cs_q − cs_k) dt_k, masked before the
//      exponential (no exp of a positive argument).
// cs, the decays, C·Bᵀ and the chunk states pass between launches through a
// float32 workspace the wrapper allocates (145 MB at the mamba2 prefill
// shape, most of it the chunk states).  Launches 2 and 4 stage their
// operands in shared memory with 16-byte cp.async copies where the rows
// allow (4-byte ones otherwise) and run two blocks an SM; launch 2's
// states leave through shared memory as whole rows, launch 3 keeps 16
// chunks' loads in flight a thread.
//
// Products run on the tensor cores as mma.sync m16n8k8 TF32 with split
// operands: a = hi + lo, hi = a truncated to TF32, lo = a − hi, and a·b
// taken as lo·hi + hi·lo + hi·hi, accumulated in float32 — about float32
// accuracy (one TF32 product keeps ~3 digits and leaves the kernel's gate).
// Exponentials, masks and the decay sums stay float32 on the CUDA cores.
// hd and N are zero-padded to multiples of 32 in shared memory; positions
// past S read as zero (dt = 0 keeps the decay flat) and each chunk's end is
// its last real position.  Large |dt·A| makes the exponentials underflow to
// 0, as in the reference.
//
// Bound on an H100: at the mamba2-370m prefill shapes (B 8, S 2048, H 32,
// hd 64, N 128) the chunked algorithm at kL = 128 is ~2.6e10 float32
// operations (C·Bᵀ counted once a batch entry and chunk) against ~0.3 GB of
// inputs and outputs: operations, 0.39 ms at 67 TFLOP/s on the CUDA cores,
// 0.16 ms as three TF32 products at 495 TFLOP/s.  The
// workspace adds ~0.4 GB of traffic (the chunk states written, rewritten
// and read), and every (b, h, chunk) block re-stages the chunk's C, B and
// C·Bᵀ that the heads share.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kL = 128;         // positions a chunk
constexpr int kRT = kL / 16;    // 16-row tiles of a chunk
constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxPad = 128;    // largest padded hd and N

using namespace tf32mma;
static_assert(kThreads == 32 * kTileWarps, "the staging helpers assume 8 warps");

struct Geometry {
  int Bsz, S, H, hd, N, HP, NP, nc;
  long long xs[4], dts[3], bs[3], cs[3];   // element strides
  int vec;                                 // kVec* bits: 16-byte rows
};
// operands whose rows can be staged by 16-byte copies
constexpr int kVecX = 1, kVecB = 2, kVecC = 4, kVecSt = 8;

// the workspace: cs (Bsz, nc, H, kL), decays (Bsz, nc, H), C·Bᵀ (Bsz, nc,
// kL, kL), chunk states (Bsz, nc, H, hd, N)
struct Work {
  float *cs, *dec, *cb, *st;
};

int pad32(int n) { return (n + 31) / 32 * 32; }

long long ws_floats(const Geometry& g, Work* w, float* base) {
  // each section a whole number of 16-byte chunks, so every one is aligned
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

// dynamic shared memory, in floats, of each launch
__host__ __device__ long long prep_floats(int NP) { return 2LL * kL * (NP + 4); }
__host__ __device__ long long state_floats(int HP, int NP) {
  return 1LL * kL * (HP + 8) + 1LL * kL * (NP + 8) + 2 * kL;
}
__host__ __device__ long long out_floats(int HP, int NP) {
  const long long a = 1LL * kL * (NP + 4) + 1LL * HP * (NP + 4);
  const long long b = 1LL * kL * (kL + 4) + 1LL * kL * (HP + 8);
  return (a > b ? a : b) + 2 * kL;
}

// ---- 1. per (b, chunk): cumulative decays, chunk decays, C·Bᵀ ---------------
__global__ void __launch_bounds__(kThreads)
ssd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ Bm, const float* __restrict__ Cm, const Geometry g,
                const Work w) {
  extern __shared__ __align__(16) float smem[];
  const int NP = g.NP, LD = NP + 4;
  float* Cs = smem;             // [kL][LD]  C rows of the chunk
  float* Bs = Cs + kL * LD;     // [kL][LD]  B rows
  const int c = blockIdx.x, b = blockIdx.y, s0 = c * kL, tid = threadIdx.x;
  const int real = min(kL, g.S - s0);     // positions of the chunk before S
  stage(Cs, LD, Cm + b * g.cs[0] + s0 * g.cs[1], g.cs[1], g.cs[2], kL, real, NP, g.N,
        g.vec & kVecC, false);
  stage(Bs, LD, Bm + b * g.bs[0] + s0 * g.bs[1], g.bs[1], g.bs[2], kL, real, NP, g.N,
        g.vec & kVecB, false);

  // cumulative dt·A of each head, in order: neighbouring cs differ by dt·A
  // to ½ ulp; the chunk's end is the very number its last real position holds
  for (int h = tid; h < g.H; h += kThreads) {
    const float a_h = A[h];
    const float* dth = dt + b * g.dts[0] + h * g.dts[2];
    float* out = w.cs + ((static_cast<long long>(b) * g.nc + c) * g.H + h) * kL;
    float run = 0.f, cs_end = 0.f;
#pragma unroll 8
    for (int t = 0; t < kL; ++t) {
      const int s = s0 + t;
      const float d = s < g.S ? dth[static_cast<long long>(s) * g.dts[1]] : 0.f;
      run = __fadd_rn(run, __fmul_rn(d, a_h));
      out[t] = run;
      if (t == real - 1) cs_end = run;
    }
    w.dec[(static_cast<long long>(b) * g.nc + c) * g.H + h] = expf(cs_end);
  }
  cp_async_wait_all();
  __syncthreads();

  // C·Bᵀ where a key can be seen (k ≤ q): warp pair p takes row tiles p and
  // kRT − 1 − p, its two warps alternate the 32-key column groups that the
  // later tile sees (the earlier one shares those it sees too)
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const int r0 = (warp >> 1) * 16, r1 = (kRT - 1 - (warp >> 1)) * 16;
  float* cb = w.cb + (static_cast<long long>(b) * g.nc + c) * kL * kL;
  for (int cg = warp & 1; cg * 32 < r1 + 16; cg += 2) {
    const bool both = cg * 32 < r0 + 16;
    float acc[2][4][4];
    zero(acc[0]);
    zero(acc[1]);
    mma3x2<4, false, true>(acc[0], acc[1], Cs, LD, Bs, LD, r0, r1, cg * 32, both ? NP : 0, NP);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (side == 0 && !both) continue;
      const int r = side ? r1 : r0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = cg * 32 + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(cb + (r + gq) * kL + k) =
            make_float2(acc[side][j][0], acc[side][j][1]);
        *reinterpret_cast<float2*>(cb + (r + gq + 8) * kL + k) =
            make_float2(acc[side][j][2], acc[side][j][3]);
      }
    }
  }
}

// ---- 2. per (b, h, chunk): the chunk's own state ------------------------------
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const Geometry g, const Work w) {
  extern __shared__ __align__(16) float smem[];
  const int HP = g.HP, NP = g.NP, LX = HP + 8, LB = NP + 8;
  float* xs = smem;              // [kL][LX]  x rows of the chunk
  float* Bw = xs + kL * LX;      // [kL][LB]  B rows, then scaled by w
  float* csS = Bw + kL * LB;     // [kL]
  float* wS = csS + kL;          // [kL]      dt, then exp(cs_end − cs_k)·dt_k
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, s0 = c * kL, tid = threadIdx.x;
  const int real = min(kL, g.S - s0);
  const long long bch = (static_cast<long long>(b) * g.nc + c) * g.H + h;

  stage(xs, LX, x + b * g.xs[0] + s0 * g.xs[1] + h * g.xs[2], g.xs[1], g.xs[3], kL, real, HP,
        g.hd, g.vec & kVecX, false);
  stage(Bw, LB, Bm + b * g.bs[0] + s0 * g.bs[1], g.bs[1], g.bs[2], kL, real, NP, g.N,
        g.vec & kVecB, false);
  stage(csS, 0, w.cs + bch * kL, 0, 1, 1, 1, kL, kL, true, false);
  stage(wS, 0, dt + b * g.dts[0] + s0 * g.dts[1] + h * g.dts[2], 0, g.dts[1], 1, 1, kL, real,
        false, false);
  cp_async_wait_all();
  __syncthreads();
  if (tid < kL) wS[tid] = expf(csS[real - 1] - csS[tid]) * wS[tid];
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  // a warp scales whole rows, four columns a lane (NP ≤ 128)
#pragma unroll 4
  for (int k = warp; k < kL; k += kThreads / 32) {
    const float wk = wS[k];
    if (lane * 4 < NP) {
      float4* r = reinterpret_cast<float4*>(Bw + k * LB + lane * 4);
      const float4 v = *r;
      *r = make_float4(v.x * wk, v.y * wk, v.z * wk, v.w * wk);
    }
  }
  __syncthreads();

  // state[d][n] = Σ_k x[k][d] (w_k B[k][n]): a warp owns 32 rows d x 32
  // columns n, two row tiles sharing each B fragment
  const int groups = NP / 32, items = (HP / 32) * groups;
  float acc[2][2][4][4];          // up to two items a warp (hd 128)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int it = warp + i * (kThreads / 32);
    zero(acc[i][0]);
    zero(acc[i][1]);
    if (it >= items) continue;
    const int r0 = (it / groups) * 32, c0 = (it % groups) * 32;
    mma3x2<4, true, false>(acc[i][0], acc[i][1], xs, LX, Bw, LB, r0, r0 + 16, c0, kL, kL);
  }
  // the state leaves through shared memory, so each warp writes whole rows
  // of it with 16-byte stores
  __syncthreads();
  float* ot = smem;              // [HP][NP + 4]
  const int LO = NP + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int it = warp + i * (kThreads / 32);
    if (it >= items) continue;
    const int r0 = (it / groups) * 32, c0 = (it % groups) * 32;
    park(ot, LO, acc[i][0], acc[i][1], r0, r0 + 16, c0);
  }
  __syncthreads();
  unpark(w.st + bch * g.hd * g.N, g.N, ot, LO, g.hd, g.N, g.vec & kVecSt);
}

// ---- 3. per (b, h) state element, in order over chunks ------------------------
// V consecutive elements a thread; the loads of a group of kGroup chunks are
// issued before any store, so they are in flight together.
constexpr int kGroup = 16;

template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const Geometry g, const Work w, float* __restrict__ state) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long hdN = static_cast<long long>(g.hd) * g.N;
  const long long total = static_cast<long long>(g.Bsz) * g.H * hdN / V;
  const long long per = hdN / V;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long bh = e / per, r = e % per;
    const long long b = bh / g.H, h = bh % g.H;
    Vec* base = reinterpret_cast<Vec*>(w.st) + (b * g.nc * g.H + h) * per + r;
    const long long step = static_cast<long long>(g.H) * per;   // one chunk
    const float* dec = w.dec + b * g.nc * g.H + h;
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0.f;
    for (int c0 = 0; c0 < g.nc; c0 += kGroup) {
      Vec v[kGroup];
      float dv[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (c0 + j < g.nc) {
          v[j] = base[(c0 + j) * step];
          dv[j] = dec[(c0 + j) * g.H];
        }
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (c0 + j < g.nc) {
          const float* vf = reinterpret_cast<const float*>(&v[j]);
          Vec in;
          float* inf = reinterpret_cast<float*>(&in);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            inf[i] = s[i];                          // the state entering chunk c
            s[i] = fmaf(s[i], dv[j], vf[i]);
          }
          base[(c0 + j) * step] = in;
        }
    }
    Vec out;
    float* of = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int i = 0; i < V; ++i) of[i] = s[i];
    reinterpret_cast<Vec*>(state)[e] = out;
  }
}

// ---- 4. per (b, h, chunk): y = exp(cs_q) C_q·s_in + M·x -----------------------
__global__ void __launch_bounds__(kThreads, 2)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, float* __restrict__ y, const Geometry g,
               const Work w) {
  extern __shared__ __align__(16) float smem[];
  const int HP = g.HP, NP = g.NP, LC = NP + 4, LM = kL + 4, LX = HP + 8;
  const long long region = out_floats(HP, NP) - 2 * kL;
  float* Cs = smem;              // phase 1: [kL][LC] C rows
  float* Ss = Cs + kL * LC;      //          [HP][LC] s_in, Ss[d][n]
  float* Ms = smem;              // phase 2: [kL][LM] M
  float* xs = Ms + kL * LM;      //          [kL][LX] x rows
  float* csS = smem + region;    // [kL]
  float* dtS = csS + kL;         // [kL]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, s0 = c * kL, tid = threadIdx.x;
  const int real = min(kL, g.S - s0);
  const long long bch = (static_cast<long long>(b) * g.nc + c) * g.H + h;

  stage(Cs, LC, Cm + b * g.cs[0] + s0 * g.cs[1], g.cs[1], g.cs[2], kL, real, NP, g.N,
        g.vec & kVecC, false);
  stage(Ss, LC, w.st + bch * g.hd * g.N, g.N, 1, HP, g.hd, NP, g.N, g.vec & kVecSt, false);
  stage(csS, 0, w.cs + bch * kL, 0, 1, 1, 1, kL, kL, true, false);
  stage(dtS, 0, dt + b * g.dts[0] + s0 * g.dts[1] + h * g.dts[2], 0, g.dts[1], 1, 1, kL, real,
        false, false);
  cp_async_wait_all();
  __syncthreads();

  // warp pair p takes row tiles p and kRT − 1 − p (equal causal work), its
  // two warps alternate 32-column groups of the head dimension
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const int groups = HP / 32;
  const int r0 = (warp >> 1) * 16, r1 = (kRT - 1 - (warp >> 1)) * 16;
  float acc[2][2][4][4];
#pragma unroll
  for (int side = 0; side < 2; ++side)
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) zero(acc[side][gi]);
  {
    const float e[2][2] = {{expf(csS[r0 + gq]), expf(csS[r0 + gq + 8])},
                           {expf(csS[r1 + gq]), expf(csS[r1 + gq + 8])}};
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int cg = (warp & 1) + 2 * gi;
      if (cg >= groups) continue;
      mma3x2<4, false, true>(acc[0][gi], acc[1][gi], Cs, LC, Ss, LC, r0, r1, cg * 32, NP, NP);
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[side][gi][j][0] *= e[side][0];
          acc[side][gi][j][1] *= e[side][0];
          acc[side][gi][j][2] *= e[side][1];
          acc[side][gi][j][3] *= e[side][1];
        }
    }
  }
  __syncthreads();

  // M from the shared C·Bᵀ where a key can be seen, zero elsewhere
  stage(Ms, LM, w.cb + (static_cast<long long>(b) * g.nc + c) * kL * kL, kL, 1, kL, kL, kL, kL,
        true, true);
  stage(xs, LX, x + b * g.xs[0] + s0 * g.xs[1] + h * g.xs[2], g.xs[1], g.xs[3], kL, real, HP,
        g.hd, g.vec & kVecX, false);
  cp_async_wait_all();
  __syncthreads();
  for (int q = warp; q < kL; q += kThreads / 32) {
    const float cq = csS[q];
    for (int k = lane; k <= q; k += 32)
      Ms[q * LM + k] = Ms[q * LM + k] * expf(cq - csS[k]) * dtS[k];
  }
  __syncthreads();

#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    const int cg = (warp & 1) + 2 * gi;
    if (cg >= groups) continue;
    mma3x2<4, false, false>(acc[0][gi], acc[1][gi], Ms, LM, xs, LX, r0, r1, cg * 32, r0 + 16,
                            r1 + 16);
  }
  const long long y_row = static_cast<long long>(g.H) * g.hd;
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    const int cg = (warp & 1) + 2 * gi;
    if (cg >= groups) continue;
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = cg * 32 + 8 * j + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = s0 + (side ? r1 : r0) + gq + 8 * half;
          if (s >= g.S) continue;
          float* yr = y + (static_cast<long long>(b) * g.S + s) * y_row +
                      static_cast<long long>(h) * g.hd;
          if (d < g.hd) yr[d] = acc[side][gi][j][2 * half];
          if (d + 1 < g.hd) yr[d + 1] = acc[side][gi][j][2 * half + 1];
        }
      }
  }
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
  return g.HP <= kMaxPad && g.NP <= kMaxPad;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(floats * sizeof(float)));
}

}  // namespace

// Float32 elements of the workspace a call needs.
extern "C" long long ssd_scan_workspace_floats(int Bsz, int S, int H, int hd, int N) {
  Geometry g;
  const long long zeros[13] = {};
  geometry(g, Bsz, S, H, hd, N, zeros);
  g.vec = 0;
  return ws_floats(g, nullptr, nullptr);
}

// x (Bsz, S, H, hd), dt (Bsz, S, H), A (H,), Bm and Cm (Bsz, S, N), float32;
// strides: 13 element strides, x (b, s, h, d), dt (b, s, h), Bm (b, s, n),
// Cm (b, s, n); y: contiguous (Bsz, S, H, hd), state: contiguous
// (Bsz, H, hd, N); ws: ssd_scan_workspace_floats(...) float32 elements.
// *launched is set to the number of CUDA launches the call made (4 when
// S > 0; S == 0 runs the state pass alone).  Returns the first error of the
// launches (cudaGetLastError() after each), or cudaErrorInvalidValue
// without a launch for hd or N above 128.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state, void* ws, int Bsz, int S,
                            int H, int hd, int N, const long long* strides, void* stream,
                            int* launched) {
  *launched = 0;
  if (Bsz == 0 || H == 0 || hd == 0 || N == 0) return static_cast<int>(cudaSuccess);
  Geometry g;
  if (!geometry(g, Bsz, S, H, hd, N, strides) || Bsz > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto rows16 = [](const void* p, long long s_b, long long s_row, long long s_col) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s_col == 1 && s_b % 4 == 0 &&
           s_row % 4 == 0;
  };
  g.vec = (rows16(x, g.xs[0], g.xs[1], g.xs[3]) && g.xs[2] % 4 == 0 ? kVecX : 0) |
          (rows16(Bm, g.bs[0], g.bs[1], g.bs[2]) ? kVecB : 0) |
          (rows16(Cm, g.cs[0], g.cs[1], g.cs[2]) ? kVecC : 0) | (N % 4 == 0 ? kVecSt : 0);
  Work w;
  ws_floats(g, &w, static_cast<float*>(ws));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  cudaError_t e;
  if (g.nc > 0) {
    const long long f1 = prep_floats(g.NP), f2 = state_floats(g.HP, g.NP),
                    f4 = out_floats(g.HP, g.NP);
    if ((e = allow_smem(ssd_prep_kernel, f1)) != cudaSuccess) return static_cast<int>(e);
    if ((e = allow_smem(ssd_state_kernel, f2)) != cudaSuccess) return static_cast<int>(e);
    if ((e = allow_smem(ssd_out_kernel, f4)) != cudaSuccess) return static_cast<int>(e);
    ssd_prep_kernel<<<dim3(g.nc, Bsz), kThreads, f1 * sizeof(float), s>>>(dtf, Af, Bf, Cf, g,
                                                                           w);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    ssd_state_kernel<<<dim3(g.nc, H, Bsz), kThreads, f2 * sizeof(float), s>>>(xf, dtf, Bf, g,
                                                                               w);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launched;
  }
  const int v = (static_cast<long long>(hd) * N) % 4 == 0 ? 4 : 1;
  const long long total = static_cast<long long>(Bsz) * H * hd * N / v;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
  if (v == 4)
    ssd_pass_kernel<4><<<grid, kThreads, 0, s>>>(g, w, static_cast<float*>(state));
  else
    ssd_pass_kernel<1><<<grid, kThreads, 0, s>>>(g, w, static_cast<float*>(state));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  if (g.nc > 0) {
    ssd_out_kernel<<<dim3(g.nc, H, Bsz), kThreads, out_floats(g.HP, g.NP) * sizeof(float), s>>>(
        xf, dtf, Cf, static_cast<float*>(y), g, w);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launched;
  }
  return static_cast<int>(cudaSuccess);
}
