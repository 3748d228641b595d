// The gradient of exact masked softmax attention over grouped-query heads:
// dq, dk and dv of o = softmax(q·kᵀ/√hd + mask)·v, given dO.
//
// Replaces no TPU kernel: the reference differentiates its attention
// (src/repro/models/layers.py::_blocked_attn, the function of the Pallas
// kernel src/repro/kernels/flash_attention.py::flash_attention) with
// jax.grad, and the port's forward is a hand-written kernel
// (flash_attention.cu), so training on the card needs this backward.  The
// mask is the forward's: key j is visible to query i when j ≤ i (causal) and
// j > i − window (sliding window); a masked score is −1e30, so a row that
// sees no key averages every value and passes no gradient to q or k.
// Layout as the forward: q and dO (B, Sq, H, hd), k and v (B, Sk, KVH, hd),
// all read through element strides; query head h reads KV head h / (H /
// KVH).  dq is a contiguous (B, Sq, H, hd) array, dk and dv contiguous
// (B, Sk, KVH, hd) ones, of the input type (float32 or bfloat16).  Every
// product and sum is float32 on the CUDA cores (TF32 stays off).
//
// With s = q·kᵀ·scale, P = softmax(s), dP = dO·vᵀ and D_i = Σ_j P_ij dP_ij:
// dv = Pᵀ·dO, dS = P ∘ (dP − D), dq = dS·k·scale, dk = dSᵀ·q·scale.  Two
// launches, deterministic (no atomics: every sum has one owner and a fixed
// order, so a rerun gives the same bits):
//
//   1. attn_bwd_dq_kernel, grid (Sq / 64, H, B), the last query blocks (the
//      longest under a causal mask) first.  A block owns 64 queries of one
//      (b, h), with q·scale and dO in shared memory, head-dim-major.  Pass 1
//      walks the visible 64-key tiles forming s and dP (K and V staged in
//      head-dim chunks, a 4 x 4 patch a thread) and keeps each row's running
//      max m, denominator l and Σ_j exp(s − m)·dP, all rescaled as the max
//      moves; so D = that sum / l comes from float32 P and dP, not from the
//      forward's output rounded to its type.  m, 1/l and D go to a float32
//      workspace (3·B·H·Sq floats) for launch 2.  Pass 2 walks the tiles
//      again: P = exp(s − m)/l, dS into shared memory, and dq += dS·k with K
//      staged as rows; each thread keeps 4 rows x hd/16 columns of dq in
//      registers.  The forward's log-sum-exp is recomputed here rather than
//      saved by the forward: the forward kernels (and the serve path's bits
//      and launch counts) stay as they are, and under rematerialisation the
//      forward runs twice a step anyway; the price is pass 1's two products.
//   2. attn_bwd_dkdv_kernel, grid (Sk / KB, KVH, B).  A block owns KB keys of
//      one KV head (KB = 64, or 32 at hd 256) with K and V resident in shared
//      memory, and walks, for each of the rep query heads that share the KV
//      head in turn, the 64-query tiles that see its keys: q·scale and dO
//      rows staged, sᵀ and dPᵀ (KB/16 keys x 4 queries a thread, summed over
//      the head dims in the same order as launch 1, so P has the same bits),
//      P and dS from launch 1's m, 1/l and D, then dv += Pᵀ·dO and
//      dk += dSᵀ·(q·scale), KB/16 keys x hd/16 columns of each a thread in
//      registers.  GQA's sum over the rep heads is this walk, in order.
//
// The pressure point is hd 256 (gemma3): launch 2's dk and dv accumulators
// are 2 x KB x hd floats, so KB is 32 there (64 registers a thread), with
// K, V (2 x 32 x 256) and the q and dO tiles (2 x 64 x 257) in 212 KB of
// shared memory, one block an SM.
//
// Bound on an H100: five products of 2·hd operations a visible (query, key)
// pair and query head (s, dP, dv, dq, dk): at gemma3-4b's training shapes
// (B 1, S 4096, 8 / 4 heads, hd 256) a global layer is 1.7e11 operations,
// 2.5 ms at the float32 CUDA-core rate, 0.17 ms at the bf16 tensor-core
// rate; this kernel runs nine such products (s and dP three times, pass 1
// included) as float32 FMAs, reading its operands from shared memory about
// once an FMA, so it is shared-memory-bound far above either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // queries a tile (both launches)
constexpr int kBK = 64;               // keys a tile of launch 1
constexpr int kQS = kBQ + 4;          // row stride of the d-major q / dO tiles and of dS
constexpr int kKS = kBK + 1;          // row stride of a transposed K or V chunk
constexpr float kMasked = -1e30f;     // the reference's masked score

struct Geometry {
  int B, Sq, Sk, H, KVH, hd, causal, window;
  float scale;
  long long qs[4], ks[4], vs[4], gs[4];   // element strides of q, k, v, dO (b, s, h, d)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool is_masked(const Geometry& g, int qi, int kj) {
  return (g.causal && kj > qi) || (g.window > 0 && kj <= qi - g.window);
}

// ---- launch 1: m, 1/l, D and dq, per 64 queries of one (b, h) ---------------
template <int HDP>
struct DqShape {
  static constexpr int DC = HDP < 64 ? HDP : 64;                          // head dims a chunk
  static constexpr int KC = (64 * 64) / HDP > kBK ? kBK : (64 * 64) / HDP;  // keys a row chunk
  static constexpr int NJ = HDP / 16;                                     // dq columns a thread
  static constexpr int BUF = DC * kKS > KC * HDP ? DC * kKS : KC * HDP;
  static constexpr int floats = 2 * HDP * kQS + BUF + DC * kKS + kBK * kQS;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                   const Geometry g) {
  using Sh = DqShape<HDP>;
  constexpr int DC = Sh::DC, KC = Sh::KC, NJ = Sh::NJ;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HDP][kQS] q·scale, head-dim-major
  float* Gs = Qs + HDP * kQS;                    // [HDP][kQS] dO, head-dim-major
  float* Kc = Gs + HDP * kQS;                    // [DC][kKS] K chunk, or [KC][HDP] K rows
  float* Vc = Kc + Sh::BUF;                      // [DC][kKS] V chunk
  float* Ps = Vc + DC * kKS;                     // [kBK][kQS] dS, key-major

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.KVH);
  const T* qb = q + b * g.qs[0] + h * g.qs[2];
  const T* gb = dout + b * g.gs[0] + h * g.gs[2];
  const T* kb = k + b * g.ks[0] + kvh * g.ks[2];
  const T* vb = v + b * g.vs[0] + kvh * g.vs[2];

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int qi = i / HDP, d = i % HDP;
    float qv = 0.f, gv = 0.f;
    if (q0 + qi < g.Sq && d < g.hd) {
      qv = to_f(qb[(q0 + qi) * g.qs[1] + d * g.qs[3]]) * g.scale;
      gv = to_f(gb[(q0 + qi) * g.gs[1] + d * g.gs[3]]);
    }
    Qs[d * kQS + qi] = qv;
    Gs[d * kQS + qi] = gv;
  }

  // the keys this block's rows can see (the forward's walk)
  const int q_last = min(q0 + kBQ, g.Sq) - 1;
  int lo = 0, hi = g.Sk;
  if (!(g.window > 0 && q_last >= g.Sk + g.window - 1)) {
    if (g.causal) hi = min(g.Sk, q_last + 1);
    if (g.window > 0) lo = max(0, q0 - g.window + 1);
  }
  const int k_first = (lo / kBK) * kBK;

  // s = (q·scale)·kᵀ and dP = dO·vᵀ of key tile k0, masked s as the forward
  // masks it: a 4 x 4 patch a thread, summed over the head dims in order
  auto tile = [&](int k0, float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
    for (int dc = 0; dc < HDP; dc += DC) {
      __syncthreads();
      for (int i = tid; i < kBK * DC; i += kThreads) {
        const int kj = i / DC, dd = i % DC, d = dc + dd;
        float kv = 0.f, vv = 0.f;
        if (k0 + kj < g.Sk && d < g.hd) {
          kv = to_f(kb[static_cast<long long>(k0 + kj) * g.ks[1] + d * g.ks[3]]);
          vv = to_f(vb[static_cast<long long>(k0 + kj) * g.vs[1] + d * g.vs[3]]);
        }
        Kc[dd * kKS + kj] = kv;
        Vc[dd * kKS + kj] = vv;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DC; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&Qs[(dc + dd) * kQS + ty * 4]);
        const float4 o = *reinterpret_cast<const float4*>(&Gs[(dc + dd) * kQS + ty * 4]);
        float kj[4], vj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kj[j] = Kc[dd * kKS + tx + 16 * j];
          vj[j] = Vc[dd * kKS + tx + 16 * j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[0][j] = fmaf(a.x, kj[j], s[0][j]);
          s[1][j] = fmaf(a.y, kj[j], s[1][j]);
          s[2][j] = fmaf(a.z, kj[j], s[2][j]);
          s[3][j] = fmaf(a.w, kj[j], s[3][j]);
          dp[0][j] = fmaf(o.x, vj[j], dp[0][j]);
          dp[1][j] = fmaf(o.y, vj[j], dp[1][j]);
          dp[2][j] = fmaf(o.z, vj[j], dp[2][j]);
          dp[3][j] = fmaf(o.w, vj[j], dp[3][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + ty * 4 + r, kj = k0 + tx + 16 * j;
        if (kj >= g.Sk)
          s[r][j] = -INFINITY;
        else if (is_masked(g, qi, kj))
          s[r][j] = kMasked;
      }
  };

  // pass 1: running max, denominator and Σ exp(s − m)·dP of each row
  float m[4], l[4], dsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kMasked;
    l[r] = dsum[r] = 0.f;
  }
  float s[4][4], dp[4][4];
  for (int k0 = k_first; k0 < hi; k0 += kBK) {
    tile(k0, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[r][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        ps += p;
        pd = fmaf(p, dp[r][j], pd);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
        pd += __shfl_xor_sync(0xffffffffu, pd, off);
      }
      l[r] = fmaf(l[r], alpha, ps);
      dsum[r] = fmaf(dsum[r], alpha, pd);
      m[r] = m_new;
    }
  }
  float inv[4], D[4];
  const long long n_rows = static_cast<long long>(g.B) * g.H * g.Sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    D[r] = dsum[r] * inv[r];
    const int qi = q0 + ty * 4 + r;
    if (tx == 0 && qi < g.Sq) {
      const long long row = (static_cast<long long>(b) * g.H + h) * g.Sq + qi;
      stats[row] = m[r];
      stats[n_rows + row] = inv[r];
      stats[2 * n_rows + row] = D[r];
    }
  }

  // pass 2: dq += dS·k
  float acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  for (int k0 = k_first; k0 < hi; k0 += kBK) {
    tile(k0, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty * 4 + r, kj = k0 + tx + 16 * j;
        const float p = expf(s[r][j] - m[r]) * inv[r];
        ds[r] = (kj < g.Sk && !is_masked(g, qi, kj)) ? p * (dp[r][j] - D[r]) : 0.f;
      }
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * kQS + ty * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    for (int kc = 0; kc < kBK; kc += KC) {
      __syncthreads();
      for (int i = tid; i < KC * HDP; i += kThreads) {
        const int kk = i / HDP, d = i % HDP, kj = k0 + kc + kk;
        float val = 0.f;
        if (kj < g.Sk && d < g.hd)
          val = to_f(kb[static_cast<long long>(kj) * g.ks[1] + d * g.ks[3]]);
        Kc[kk * HDP + d] = val;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float4 p = *reinterpret_cast<const float4*>(&Ps[(kc + kk) * kQS + ty * 4]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float kv = Kc[kk * HDP + tx + 16 * j];
          acc[0][j] = fmaf(p.x, kv, acc[0][j]);
          acc[1][j] = fmaf(p.y, kv, acc[1][j]);
          acc[2][j] = fmaf(p.z, kv, acc[2][j]);
          acc[3][j] = fmaf(p.w, kv, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= g.Sq) continue;
    T* row = dq + ((static_cast<long long>(b) * g.Sq + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.hd) row[d] = from_f<T>(acc[r][j] * g.scale);
    }
  }
}

// ---- launch 2: dk and dv, per KB keys of one (b, KV head) --------------------
template <int HDP>
struct DkdvShape {
  static constexpr int KB = HDP > 128 ? 32 : 64;   // keys a block
  static constexpr int KR = KB / 16;               // keys a thread
  static constexpr int KBP = KB + 1;               // row stride of the d-major K and V
  static constexpr int QP = HDP + 1;               // row stride of the q and dO rows
  static constexpr int NJ = HDP / 16;              // dk / dv columns a thread
  static constexpr int floats = 2 * HDP * KBP + 2 * kBQ * QP + 2 * kBQ * KBP + 3 * kBQ;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                     const float* __restrict__ stats, const Geometry g) {
  using Sh = DkdvShape<HDP>;
  constexpr int KB = Sh::KB, KR = Sh::KR, KBP = Sh::KBP, QP = Sh::QP, NJ = Sh::NJ;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [HDP][KBP] K, head-dim-major
  float* Vs = Ks + HDP * KBP;                    // [HDP][KBP] V
  float* Qr = Vs + HDP * KBP;                    // [kBQ][QP] q·scale rows
  float* Gr = Qr + kBQ * QP;                     // [kBQ][QP] dO rows
  float* Pt = Gr + kBQ * QP;                     // [kBQ][KBP] P, query-major
  float* Dt = Pt + kBQ * KBP;                    // [kBQ][KBP] dS
  float* Ms = Dt + kBQ * KBP;                    // [kBQ] m, then 1/l, then D
  float* Is = Ms + kBQ;
  float* Ds = Is + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * KB, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = g.H / g.KVH;
  const T* kb = k + b * g.ks[0] + kvh * g.ks[2];
  const T* vb = v + b * g.vs[0] + kvh * g.vs[2];
  for (int i = tid; i < KB * HDP; i += kThreads) {
    const int kj = i / HDP, d = i % HDP;
    float kv = 0.f, vv = 0.f;
    if (k0 + kj < g.Sk && d < g.hd) {
      kv = to_f(kb[static_cast<long long>(k0 + kj) * g.ks[1] + d * g.ks[3]]);
      vv = to_f(vb[static_cast<long long>(k0 + kj) * g.vs[1] + d * g.vs[3]]);
    }
    Ks[d * KBP + kj] = kv;
    Vs[d * KBP + kj] = vv;
  }

  // the queries that see these keys; with a window, rows past Sk + window − 1
  // see no key and average them all, so then every later row is walked
  const int k_last = min(k0 + KB, g.Sk) - 1;
  const int qlo = g.causal ? k0 : 0;
  int qhi = g.window > 0 ? min(g.Sq, k_last + g.window) : g.Sq;
  if (g.window > 0 && g.Sq > g.Sk + g.window - 1) qhi = g.Sq;

  float dK[KR][NJ], dV[KR][NJ];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dK[r][j] = dV[r][j] = 0.f;
  const long long n_rows = static_cast<long long>(g.B) * g.H * g.Sq;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = kvh * rep + hr;
    const T* qb = q + b * g.qs[0] + h * g.qs[2];
    const T* gb = dout + b * g.gs[0] + h * g.gs[2];
    const float* st = stats + (static_cast<long long>(b) * g.H + h) * g.Sq;
    for (int q0 = (qlo / kBQ) * kBQ; q0 < qhi; q0 += kBQ) {
      __syncthreads();
      for (int i = tid; i < kBQ * HDP; i += kThreads) {
        const int qq = i / HDP, d = i % HDP;
        float qv = 0.f, gv = 0.f;
        if (q0 + qq < g.Sq && d < g.hd) {
          qv = to_f(qb[(q0 + qq) * g.qs[1] + d * g.qs[3]]) * g.scale;
          gv = to_f(gb[(q0 + qq) * g.gs[1] + d * g.gs[3]]);
        }
        Qr[qq * QP + d] = qv;
        Gr[qq * QP + d] = gv;
      }
      if (tid < kBQ) {
        const bool in = q0 + tid < g.Sq;
        Ms[tid] = in ? st[q0 + tid] : 0.f;
        Is[tid] = in ? st[n_rows + q0 + tid] : 0.f;
        Ds[tid] = in ? st[2 * n_rows + q0 + tid] : 0.f;
      }
      __syncthreads();

      // sᵀ and dPᵀ: KR keys x 4 queries a thread, head dims in order
      float s[KR][4], dp[KR][4];
#pragma unroll
      for (int r = 0; r < KR; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HDP; ++d) {
        float kk[KR], vv[KR], qq[4], gg[4];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          kk[r] = Ks[d * KBP + ty * KR + r];
          vv[r] = Vs[d * KBP + ty * KR + r];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = Qr[(tx + 16 * j) * QP + d];
          gg[j] = Gr[(tx + 16 * j) * QP + d];
        }
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[r][j] = fmaf(qq[j], kk[r], s[r][j]);
            dp[r][j] = fmaf(gg[j], vv[r], dp[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < KR; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = tx + 16 * j, qi = q0 + ql, kj = k0 + ty * KR + r;
          const bool valid = qi < g.Sq && kj < g.Sk, masked = is_masked(g, qi, kj);
          const float p =
              valid ? expf((masked ? kMasked : s[r][j]) - Ms[ql]) * Is[ql] : 0.f;
          Pt[ql * KBP + ty * KR + r] = p;
          Dt[ql * KBP + ty * KR + r] = valid && !masked ? p * (dp[r][j] - Ds[ql]) : 0.f;
        }
      __syncthreads();

      // dv += Pᵀ·dO, dk += dSᵀ·(q·scale)
#pragma unroll 2
      for (int ql = 0; ql < kBQ; ++ql) {
        float pr[KR], dr[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          pr[r] = Pt[ql * KBP + ty * KR + r];
          dr[r] = Dt[ql * KBP + ty * KR + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float go = Gr[ql * QP + tx + 16 * j], qv = Qr[ql * QP + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < KR; ++r) {
            dV[r][j] = fmaf(pr[r], go, dV[r][j]);
            dK[r][j] = fmaf(dr[r], qv, dK[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kj = k0 + ty * KR + r;
    if (kj >= g.Sk) continue;
    const long long off = ((static_cast<long long>(b) * g.Sk + kj) * g.KVH + kvh) * g.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.hd) {
        dk[off + d] = from_f<T>(dK[r][j]);
        dv[off + d] = from_f<T>(dV[r][j]);
      }
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* fn, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, const Geometry& g, cudaStream_t st, int* launched) {
  constexpr int smem1 = DqShape<HDP>::floats * static_cast<int>(sizeof(float));
  constexpr int smem2 = DkdvShape<HDP>::floats * static_cast<int>(sizeof(float));
  static bool opted1 = false, opted2 = false;
  cudaError_t e;
  if ((e = allow_smem(attn_bwd_dq_kernel<T, HDP>, smem1, opted1)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = allow_smem(attn_bwd_dkdv_kernel<T, HDP>, smem2, opted2)) != cudaSuccess)
    return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  attn_bwd_dq_kernel<T, HDP><<<dim3((g.Sq + kBQ - 1) / kBQ, g.H, g.B), kThreads, smem1, st>>>(
      qt, kt, vt, gt, static_cast<T*>(dq), stats, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  constexpr int KB = DkdvShape<HDP>::KB;
  attn_bwd_dkdv_kernel<T, HDP><<<dim3((g.Sk + KB - 1) / KB, g.KVH, g.B), kThreads, smem2, st>>>(
      qt, kt, vt, gt, static_cast<T*>(dk), static_cast<T*>(dv), stats, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, float* stats, const Geometry& g, cudaStream_t st, int* launched) {
  if (g.hd <= 32) return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  if (g.hd <= 64) return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  if (g.hd <= 128) return launch<T, 128>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  return launch<T, 256>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
}

template <typename F>
int attributes_of(F* fn, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

template <typename T>
int attributes_t(int hdp, int which, int* out) {
  switch (hdp * 2 + which) {
    case 64: return attributes_of(attn_bwd_dq_kernel<T, 32>, out);
    case 65: return attributes_of(attn_bwd_dkdv_kernel<T, 32>, out);
    case 128: return attributes_of(attn_bwd_dq_kernel<T, 64>, out);
    case 129: return attributes_of(attn_bwd_dkdv_kernel<T, 64>, out);
    case 256: return attributes_of(attn_bwd_dq_kernel<T, 128>, out);
    case 257: return attributes_of(attn_bwd_dkdv_kernel<T, 128>, out);
    case 512: return attributes_of(attn_bwd_dq_kernel<T, 256>, out);
    case 513: return attributes_of(attn_bwd_dkdv_kernel<T, 256>, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Float32 elements of the workspace a call needs: each query row's m, 1/l and D.
extern "C" long long flash_attention_bwd_workspace_floats(int B, int Sq, int H) {
  return 3LL * B * H * Sq;
}

// q and dout (B, Sq, H, hd), k and v (B, Sk, KVH, hd), one type (dtype 0
// float32, 1 bfloat16); strides: 16 element strides, q, k, v, dout each
// (b, s, h, d).  dq: contiguous (B, Sq, H, hd); dk, dv: contiguous
// (B, Sk, KVH, hd), all of the input type; ws:
// flash_attention_bwd_workspace_floats(B, Sq, H) float32 elements.  causal
// 0 or 1; window 0 for none.  *launched: the CUDA launches made (2).
// Returns the first CUDA error (cudaGetLastError() after each launch).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, void* ws,
                                   int dtype, int B, int Sq, int Sk, int H, int KVH, int hd,
                                   int causal, int window, const long long* strides,
                                   void* stream, int* launched) {
  *launched = 0;
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > 256 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.B = B; g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.hd = hd;
  g.causal = causal; g.window = window;
  g.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  for (int i = 0; i < 4; ++i) {
    g.qs[i] = strides[i];
    g.ks[i] = strides[4 + i];
    g.vs[i] = strides[8 + i];
    g.gs[i] = strides[12 + i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(ws);
  if (dtype == 0) return dispatch<float>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and the largest block of
// launch `which` (0 dq, 1 dk/dv) for (dtype, padded head size 32, 64, 128 or
// 256).  out: three ints.  Returns a CUDA error.
extern "C" int flash_attention_bwd_attributes(int dtype, int hdp, int which, int* out) {
  if (which != 0 && which != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return attributes_t<float>(hdp, which, out);
  if (dtype == 1) return attributes_t<__nv_bfloat16>(hdp, which, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
