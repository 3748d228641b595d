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
// Layout as the forward: q and dO (B, Sq, H, hd), k and v (B, Sk, KVH, hd);
// query head h reads KV head h / (H / KVH).  dq is a contiguous
// (B, Sq, H, hd) array, dk and dv contiguous (B, Sk, KVH, hd) ones, of the
// input type (float32 or bfloat16).  Every sum is float32.
//
// With s = q·kᵀ·scale, P = softmax(s), dP = dO·vᵀ and D_i = Σ_j P_ij dP_ij:
// dv = Pᵀ·dO, dS = P ∘ (dP − D), dq = dS·k·scale, dk = dSᵀ·q·scale.  Two
// launches for either type, deterministic (no atomics: every sum has one
// owner and a fixed order, so a rerun gives the same bits).  Launch 1 walks
// each query block's visible keys twice: pass 1 keeps each row's running max
// m, denominator l and Σ_j exp(s − m)·dP, all rescaled as the max moves, so
// D = that sum / l comes from float32 P and dP, not from the forward's
// output rounded to its type; m, 1/l and D go to a float32 workspace for
// launch 2; pass 2 forms dS and dq.  The forward's log-sum-exp is
// recomputed here rather than saved by the forward: the forward kernels (and
// the serve path's bits and launch counts) stay as they are, and under
// rematerialisation the forward runs twice a step anyway; the price is pass
// 1's two products.  Launch 2 owns a block of keys of one KV head and walks,
// for each of the rep query heads that share it in turn, the query tiles
// that see those keys, with P and dS from launch 1's statistics: GQA's sum
// over the rep heads is that walk, in order (in bfloat16 each head's part
// summed into float32 partials: see below).
//
// bfloat16 — attn_bwd_dq_wgmma and attn_bwd_dkdv_wgmma, on the tensor cores,
// built as the forward's flash_kernel_wgmma (helpers in wgmma_tma.cuh): 384
// threads, warpgroup 0 the producer (setmaxnreg 24; one thread keeps TMA
// loads in flight — cp.async.bulk.tensor, 128-byte swizzle, zero fill past
// the edges — handing tiles over through full / empty mbarrier rings of two
// stages), warpgroups 1 and 2 the consumers (setmaxnreg 240): wgmma with
// f32 accumulators in registers, one block an SM.
//   1. dq: grid (H, B, Sq / 128), the last query blocks (the longest under a
//      causal mask) first.  q and dO of 128 queries stay resident (64 KB
//      each at hd 256), each consumer owning 64 rows; K and V stream in
//      32-key stages (16 KB each at hd 256; 192 KB in all).  s = q·kᵀ and
//      dP = dO·vᵀ by wgmma m64n32k16 from shared memory, both exact-input
//      products; then dq += dS·K with dS from registers and K as the MN-major
//      operand, the 64 × hd accumulator (128 registers a thread at hd 256)
//      held for the whole walk.  Statistics are kept in base 2 (m of
//      s·log2(e)/√hd), as the forward keeps them.
//   2. dk and dv: grid (Sk / 64, KVH, B).  K and V of 64 keys stay resident
//      (64 KB at hd 256); q and dO tiles of 64 queries and their m, 1/l and
//      D stream through the ring (64 KB a stage at hd 256).  A 64 × hd f32
//      accumulator is 128 registers a thread at hd 256, so dk and dv cannot
//      share a warpgroup: consumer 1 owns dv — sᵀ = K·qᵀ, P, dv += Pᵀ·dO —
//      and consumer 2 owns dk — dPᵀ = V·dOᵀ, then dS from consumer 1's P,
//      dk += dSᵀ·q.  P crosses between them through shared memory (16 KB, in
//      the accumulator's own thread layout, so each thread reads what its
//      counterpart wrote) under two named barriers.  Shared memory at hd
//      256: 64 + 2 × 64.75 + 16 KB = 210 KB of the 227.
//   wgmma's float32 accumulation drops a little toward zero on every add
//   (measured on the card by tools/attn_bwd_bias.py: dk and dv shrink by
//   ~2e-8 of their size an add),
//   so a walk over all of a KV head's query heads in one accumulator (48 ×
//   64 query tiles, 24,576 adds, at granite-20b's 48 heads on one KV head)
//   left the gate by a bias of −4.7e-4; the accumulator holds one query
//   head's walk, and at each head's end the consumer adds it into a float32
//   partial sum of its own in global memory (`part`, one rounded add an
//   element a head, in head order; the last head's added as it is stored).
//   The scale 1/√hd is applied in float32 after the products (q·scale
//   rounded to bf16 would add an error at hd 128, where it is not a power of
//   two).  P (into dv) and dS (into dq and dk) must be bf16 to enter wgmma;
//   one bf16 rounding of either leaves the backward's gate (PERF.md §2: one
//   bf16 ulp of the float64 value + 1e-4·max|f64|) by 6–10× at hd 256 in
//   the CPU emulation (tests/test_torch_flash_attention.py), so each is
//   split, x = bf16(x) + bf16(x − bf16(x)), and each of those products is
//   two wgmmas (emulated: 0.013 of the gate before the output's rounding).
//   Requires TMA's layout (unit head-dim stride, other strides multiples of
//   8 elements, 16-byte aligned bases, hd a multiple of 8; the wrapper
//   checks q, k, v and makes dO contiguous); templates for hd ≤ 64, 128,
//   256.  The workspace rows are padded to a multiple of 128 queries, so a
//   query tile's statistics are one aligned 256-byte bulk copy each.
//
// float32 — attn_bwd_dq_kernel and attn_bwd_dkdv_kernel, FMAs on the CUDA
// cores (TF32 stays off), any strides, 256 threads.  Launch 1: grid
// (Sq / 64, H, B), q·scale and dO in shared memory head-dim-major, each
// thread a 4 x 4 patch of s and dP and 4 rows x hd/16 columns of dq.  Launch
// 2: a block owns KB keys (64, or 32 at hd 256: its dk and dv accumulators
// are 2 x KB x hd floats), K and V resident, KB/16 keys x hd/16 columns of
// each a thread.
//
// Bound on an H100: five products of 2·hd operations a visible (query, key)
// pair and query head (s, dP, dv, dq, dk): at gemma3-4b's training shapes
// (B 1, S 4096, 8 / 4 heads, hd 256) a global layer is 1.7e11 operations,
// 0.17 ms at the bf16 tensor-core rate (2.6 ms at the float32 CUDA-core
// rate).  The bf16 kernels run twelve bf16 products a pair (s and dP twice
// in launch 1 and once in launch 2, dq, dk and dv as split pairs), so their
// floor is about 2.4× that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // queries a tile (both launches)
constexpr int kBK = 64;               // keys a tile of launch 1
constexpr int kQS = kBQ + 4;          // row stride of the d-major q / dO tiles and of dS
constexpr int kKS = kBK + 1;          // row stride of a transposed K or V chunk
constexpr float kMasked = -1e30f;     // the reference's masked score

struct Geometry {
  int B, Sq, Sk, H, KVH, hd, causal, window, q_pos0;
  float scale;
  long long qs[4], ks[4], vs[4], gs[4];   // element strides of q, k, v, dO (b, s, h, d)
};

// query row qi stands at position q_pos0 + qi
__device__ __forceinline__ bool is_masked(const Geometry& g, int qi, int kj) {
  qi += g.q_pos0;
  return (g.causal && kj > qi) || (g.window > 0 && kj <= qi - g.window);
}

// the local query rows [lo, hi) that keys [k0, k_last] are visible to; with
// a window, rows at positions past Sk + window − 1 see no key and average
// them all, so then every later row is walked
__device__ __forceinline__ void query_range(int Sq, int Sk, int causal, int window, int q_pos0,
                                            int k0, int k_last, int& lo, int& hi) {
  lo = causal ? max(0, k0 - q_pos0) : 0;
  hi = window > 0 ? max(0, min(Sq, k_last + window - q_pos0)) : Sq;
  if (window > 0 && q_pos0 + Sq > Sk + window - 1) hi = Sq;
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

template <int HDP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ stats,
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
  const float* qb = q + b * g.qs[0] + h * g.qs[2];
  const float* gb = dout + b * g.gs[0] + h * g.gs[2];
  const float* kb = k + b * g.ks[0] + kvh * g.ks[2];
  const float* vb = v + b * g.vs[0] + kvh * g.vs[2];

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int qi = i / HDP, d = i % HDP;
    float qv = 0.f, gv = 0.f;
    if (q0 + qi < g.Sq && d < g.hd) {
      qv = qb[(q0 + qi) * g.qs[1] + d * g.qs[3]] * g.scale;
      gv = gb[(q0 + qi) * g.gs[1] + d * g.gs[3]];
    }
    Qs[d * kQS + qi] = qv;
    Gs[d * kQS + qi] = gv;
  }

  // the keys this block's rows can see (the forward's walk, in positions)
  const int p0 = g.q_pos0 + q0, p_last = g.q_pos0 + min(q0 + kBQ, g.Sq) - 1;
  int lo = 0, hi = g.Sk;
  if (!(g.window > 0 && p_last >= g.Sk + g.window - 1)) {
    if (g.causal) hi = min(g.Sk, p_last + 1);
    if (g.window > 0) lo = max(0, p0 - g.window + 1);
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
          kv = kb[static_cast<long long>(k0 + kj) * g.ks[1] + d * g.ks[3]];
          vv = vb[static_cast<long long>(k0 + kj) * g.vs[1] + d * g.vs[3]];
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
          val = kb[static_cast<long long>(kj) * g.ks[1] + d * g.ks[3]];
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
    float* row = dq + ((static_cast<long long>(b) * g.Sq + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.hd) row[d] = acc[r][j] * g.scale;
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

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
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
  const float* kb = k + b * g.ks[0] + kvh * g.ks[2];
  const float* vb = v + b * g.vs[0] + kvh * g.vs[2];
  for (int i = tid; i < KB * HDP; i += kThreads) {
    const int kj = i / HDP, d = i % HDP;
    float kv = 0.f, vv = 0.f;
    if (k0 + kj < g.Sk && d < g.hd) {
      kv = kb[static_cast<long long>(k0 + kj) * g.ks[1] + d * g.ks[3]];
      vv = vb[static_cast<long long>(k0 + kj) * g.vs[1] + d * g.vs[3]];
    }
    Ks[d * KBP + kj] = kv;
    Vs[d * KBP + kj] = vv;
  }

  // the queries that see these keys
  const int k_last = min(k0 + KB, g.Sk) - 1;
  int qlo, qhi;
  query_range(g.Sq, g.Sk, g.causal, g.window, g.q_pos0, k0, k_last, qlo, qhi);

  float dK[KR][NJ], dV[KR][NJ];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dK[r][j] = dV[r][j] = 0.f;
  const long long n_rows = static_cast<long long>(g.B) * g.H * g.Sq;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = kvh * rep + hr;
    const float* qb = q + b * g.qs[0] + h * g.qs[2];
    const float* gb = dout + b * g.gs[0] + h * g.gs[2];
    const float* st = stats + (static_cast<long long>(b) * g.H + h) * g.Sq;
    for (int q0 = (qlo / kBQ) * kBQ; q0 < qhi; q0 += kBQ) {
      __syncthreads();
      for (int i = tid; i < kBQ * HDP; i += kThreads) {
        const int qq = i / HDP, d = i % HDP;
        float qv = 0.f, gv = 0.f;
        if (q0 + qq < g.Sq && d < g.hd) {
          qv = qb[(q0 + qq) * g.qs[1] + d * g.qs[3]] * g.scale;
          gv = gb[(q0 + qq) * g.gs[1] + d * g.gs[3]];
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
        dk[off + d] = dK[r][j];
        dv[off + d] = dV[r][j];
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

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, const Geometry& g, cudaStream_t st, int* launched) {
  constexpr int smem1 = DqShape<HDP>::floats * static_cast<int>(sizeof(float));
  constexpr int smem2 = DkdvShape<HDP>::floats * static_cast<int>(sizeof(float));
  static bool opted1 = false, opted2 = false;
  cudaError_t e;
  if ((e = allow_smem(attn_bwd_dq_kernel<HDP>, smem1, opted1)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = allow_smem(attn_bwd_dkdv_kernel<HDP>, smem2, opted2)) != cudaSuccess)
    return static_cast<int>(e);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  attn_bwd_dq_kernel<HDP><<<dim3((g.Sq + kBQ - 1) / kBQ, g.H, g.B), kThreads, smem1, st>>>(
      qt, kt, vt, gt, static_cast<float*>(dq), stats, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  constexpr int KB = DkdvShape<HDP>::KB;
  attn_bwd_dkdv_kernel<HDP><<<dim3((g.Sk + KB - 1) / KB, g.KVH, g.B), kThreads, smem2, st>>>(
      qt, kt, vt, gt, static_cast<float*>(dk), static_cast<float*>(dv), stats, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  return 0;
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, float* stats, const Geometry& g, cudaStream_t st, int* launched) {
  if (g.hd <= 32) return launch<32>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  if (g.hd <= 64) return launch<64>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  if (g.hd <= 128) return launch<128>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
  return launch<256>(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
}


// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma kernels fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgtma;

constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;            // ring depth of both launches
constexpr int kRow = 128;             // bytes of a swizzled row: 64 bf16 head dims
constexpr int kBQ1 = 128;             // launch 1: queries a block (two consumers of 64)
constexpr int kBK1 = 32;              // launch 1: keys a stage
constexpr int kBK2 = 64;              // launch 2: keys a block
constexpr int kBQ2 = 64;              // launch 2: queries a stage
constexpr int kQBox = 64;             // rows of a q / dO TMA box
constexpr int kKBox = 32;             // rows of a K / V TMA box
constexpr int kPad = 128;             // workspace rows are padded to a multiple of this

struct Geometry {
  int B, Sq, Sk, H, KVH, hd, causal, window, q_pos0, SqP;   // SqP: Sq rounded up to kPad
  float scale, scale_log2;                                  // 1/√hd, log2(e)/√hd
};

// query row qi stands at position q_pos0 + qi
__device__ __forceinline__ bool is_masked(const Geometry& g, int qi, int kj) {
  qi += g.q_pos0;
  return (g.causal && kj > qi) || (g.window > 0 && kj <= qi - g.window);
}

// the keys [lo, hi) that rows [r0, r_last] (at positions q_pos0 + row) can
// see; every key when the last row sees none (the reference's −1e30 rows
// then average every value)
__device__ __forceinline__ void key_range(const Geometry& g, int r0, int r_last, int& lo,
                                          int& hi) {
  r0 += g.q_pos0;
  r_last += g.q_pos0;
  lo = 0;
  hi = g.Sk;
  if (g.window > 0 && r_last >= g.Sk + g.window - 1) return;
  if (g.causal) hi = min(g.Sk, r_last + 1);
  if (g.window > 0) lo = max(0, r0 - g.window + 1);
}

// the 32 f32 values of a 64-row accumulator (columns 8kc..8kc + 7 of 16 a
// chunk) as wgmma A fragments of x = hi + lo, hi = bf16(x), lo = bf16(x − hi):
// key chunk kc, fragment r holds x[8kc + 2r], x[8kc + 2r + 1]
template <int N>
__device__ __forceinline__ void split_bf16(const float (&x)[N], uint32_t (&hi)[N / 2],
                                           uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    const float2 hf = __bfloat1622float2(h2);
    hi[j] = bf16x2_bits(h2);
    lo[j] = bf16x2_bits(__floats2bfloat162_rn(x[2 * j] - hf.x, x[2 * j + 1] - hf.y));
  }
}

// d (64 x HDP) += (hi + lo)·B over the 16-deep chunks of a K-wide A, B
// MN-major in shared memory from `b` (rows of 128 bytes, head-dim chunks
// `rows` rows apart)
template <int HDP, int K>
__device__ __forceinline__ void product_split(float (&d)[HDP / 2], const uint32_t (&hi)[K / 4],
                                              const uint32_t (&lo)[K / 4], uint32_t b, int rows) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    const uint64_t bd = smem_desc(b + kc * 16 * kRow, rows * kRow, 1024);
    const uint32_t ah[4] = {hi[4 * kc], hi[4 * kc + 1], hi[4 * kc + 2], hi[4 * kc + 3]};
    const uint32_t al[4] = {lo[4 * kc], lo[4 * kc + 1], lo[4 * kc + 2], lo[4 * kc + 3]};
    wgmma_rs<HDP>(d, ah, bd);
    wgmma_rs<HDP>(d, al, bd);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// ---- launch 1: m, 1/l, D and dq, per 128 queries of one (b, h) --------------
template <int HDP>
struct Layout1 {                      // dynamic shared memory, from a 1024-aligned base
  static constexpr int kChunks = HDP / 64;
  static constexpr int q_bytes = kBQ1 * HDP * 2;      // q tile; the dO tile the same
  static constexpr int kv_bytes = kBK1 * HDP * 2;     // one K or V stage
  static constexpr int q_off = 0;
  static constexpr int g_off = q_bytes;
  static constexpr int k_off = 2 * q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  static constexpr int bytes = bar_off + (1 + 4 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;          // slack to align the base
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap gmap, __nv_bfloat16* __restrict__ dq,
                  float* __restrict__ stats, const Geometry g) {
  using L = Layout1<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle atoms are 1024 bytes
  const uint32_t sQ = base + L::q_off, sG = base + L::g_off;
  const uint32_t sK = base + L::k_off, sV = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ1;
  const int kvh = h / (g.H / g.KVH);
  int lo, hi;
  key_range(g, q0, min(q0 + kBQ1, g.Sq) - 1, lo, hi);
  const int t0 = lo / kBK1;
  const int n_tiles = (hi - t0 * kBK1 + kBK1 - 1) / kBK1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);     // lane 0 of each of the 8 consumer warps
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    // ---- producer: q and dO once, then K and V for pass 1 and again for pass 2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::q_bytes);
      for (int c = 0; c < L::kChunks; ++c)
        for (int r = 0; r < kBQ1; r += kQBox) {
          tma_load(sQ + (c * kBQ1 + r) * kRow, &qmap, q_full, c * 64, q0 + r, h, b);
          tma_load(sG + (c * kBQ1 + r) * kRow, &gmap, q_full, c * 64, q0 + r, h, b);
        }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        const int k0 = (t0 + i % n_tiles) * kBK1;
        mbar_wait(k_empty(s), phase ^ 1);
        mbar_expect_tx(k_full(s), L::kv_bytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sK + s * L::kv_bytes + c * kBK1 * kRow, &kmap, k_full(s), c * 64, k0, kvh, b);
        mbar_wait(v_empty(s), phase ^ 1);
        mbar_expect_tx(v_full(s), L::kv_bytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sV + s * L::kv_bytes + c * kBK1 * kRow, &vmap, v_full(s), c * 64, k0, kvh, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns block rows [64·cw, 64·cw + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int row_a = cw * 64 + warp * 16 + lane / 4;   // block row of the thread's first row
  const int qa = q0 + row_a, qb = qa + 8;             // its two query rows
  const int w0 = q0 + cw * 64, w_last = min(w0 + 63, g.Sq - 1);
  const bool active = w0 < g.Sq;
  int wlo, whi;
  key_range(g, w0, w_last, wlo, whi);
  const uint32_t sQw = sQ + cw * 64 * kRow, sGw = sG + cw * 64 * kRow;

  // S = q·kᵀ and dP = dO·vᵀ of stage s (64 x 32 each, f32)
  auto products = [&](int s, float (&S)[16], float (&dP)[16]) {
    const uint32_t sKs = sK + s * L::kv_bytes, sVs = sV + s * L::kv_bytes;
#pragma unroll
    for (int j = 0; j < 16; ++j) S[j] = dP[j] = 0.f;
    fence_regs(S);
    fence_regs(dP);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBQ1 * kRow + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kBK1 * kRow + (kk % 4) * 32;
      wgmma_ss_n32(S, smem_desc(sQw + off, 16, 1024), smem_desc(sKs + koff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBQ1 * kRow + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kBK1 * kRow + (kk % 4) * 32;
      wgmma_ss_n32(dP, smem_desc(sGw + off, 16, 1024), smem_desc(sVs + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(S);
    fence_regs(dP);
  };
  auto key_of = [&](int k0, int j) { return k0 + 8 * (j / 4) + 2 * quad + (j & 1); };

  // pass 1: running max (base 2), denominator and Σ exp2(x − m)·dP, each
  // thread's share of its two rows (the max is the row's, so the shares
  // rescale alike)
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f, d_a = 0.f, d_b = 0.f;
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (t0 + i) * kBK1;
    const bool work = active && k0 + kBK1 > wlo && k0 < whi;
    float S[16], dP[16];
    mbar_wait(k_full(s), phase);
    mbar_wait(v_full(s), phase);
    if (work) products(s, S, dP);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(k_empty(s));
      mbar_arrive(v_empty(s));
    }
    if (!work) continue;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int kj = key_of(k0, j), qi = (j & 2) ? qb : qa;
      float x = S[j] * g.scale_log2;
      if (kj >= g.Sk)
        x = -INFINITY;
      else if (is_masked(g, qi, kj))
        x = kMasked;
      S[j] = x;
      if (j & 2) mx_b = fmaxf(mx_b, x);
      else mx_a = fmaxf(mx_a, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float ps_a = 0.f, ps_b = 0.f, pd_a = 0.f, pd_b = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = exp2f(S[j] - ((j & 2) ? m_b : m_a));
      if (j & 2) {
        ps_b += p;
        pd_b = fmaf(p, dP[j], pd_b);
      } else {
        ps_a += p;
        pd_a = fmaf(p, dP[j], pd_a);
      }
    }
    l_a = fmaf(l_a, alpha_a, ps_a);
    l_b = fmaf(l_b, alpha_b, ps_b);
    d_a = fmaf(d_a, alpha_a, pd_a);
    d_b = fmaf(d_b, alpha_b, pd_b);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
    d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const float D_a = d_a * inv_a, D_b = d_b * inv_b;
  if (quad == 0) {   // every row of the padded workspace; zeros past Sq
    const long long n_rows = static_cast<long long>(g.B) * g.H * g.SqP;
    const long long r0 = (static_cast<long long>(b) * g.H + h) * g.SqP;
    const bool in_a = qa < g.Sq, in_b = qb < g.Sq;
    stats[r0 + qa] = in_a ? m_a : 0.f;
    stats[n_rows + r0 + qa] = in_a ? inv_a : 0.f;
    stats[2 * n_rows + r0 + qa] = in_a ? D_a : 0.f;
    stats[r0 + qb] = in_b ? m_b : 0.f;
    stats[n_rows + r0 + qb] = in_b ? inv_b : 0.f;
    stats[2 * n_rows + r0 + qb] = in_b ? D_b : 0.f;
  }

  // pass 2: dS = P ∘ (dP − D), dq += (dS_hi + dS_lo)·K
  float acc[HDP / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
  for (int i = n_tiles; i < 2 * n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (t0 + i - n_tiles) * kBK1;
    const bool work = active && k0 + kBK1 > wlo && k0 < whi;
    float S[16], dS[16];
    mbar_wait(k_full(s), phase);
    mbar_wait(v_full(s), phase);
    if (work) products(s, S, dS);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(s));
    if (work) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kj = key_of(k0, j), qi = (j & 2) ? qb : qa;
        const float p = exp2f(S[j] * g.scale_log2 - ((j & 2) ? m_b : m_a)) *
                        ((j & 2) ? inv_b : inv_a);
        dS[j] = kj < g.Sk && !is_masked(g, qi, kj) ? p * (dS[j] - ((j & 2) ? D_b : D_a)) : 0.f;
      }
      uint32_t ds_hi[8], ds_lo[8];
      split_bf16(dS, ds_hi, ds_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      product_split<HDP, kBK1>(acc, ds_hi, ds_lo, sK + s * L::kv_bytes, kBK1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(s));
  }
  if (!active) return;

#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * quad;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = half ? qb : qa;
      if (qi >= g.Sq || d >= g.hd) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          dq + ((static_cast<long long>(b) * g.Sq + qi) * g.H + h) * g.hd + d) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * g.scale,
                                acc[4 * j + 2 * half + 1] * g.scale);
    }
  }
}

// ---- launch 2: dk and dv, per 64 keys of one (b, KV head) --------------------
// The consumer's accumulator (64 keys × hd) into its float32 partial sums
// `part` (the layout of dk and dv, float32): stored by the first query
// head, added with one rounding an element by each later one; then zeroed.
template <int HDP>
__device__ __forceinline__ void flush_partial(float (&acc)[HDP / 2], float* __restrict__ part,
                                              bool first, int ka, int kb, int quad, int kvh,
                                              int b, const Geometry& g) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * quad;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = half ? kb : ka;
      float& x0 = acc[4 * j + 2 * half];
      float& x1 = acc[4 * j + 2 * half + 1];
      if (kj < g.Sk && d < g.hd) {
        float2* const p = reinterpret_cast<float2*>(
            part + ((static_cast<long long>(b) * g.Sk + kj) * g.KVH + kvh) * g.hd + d);
        float2 x = make_float2(x0, x1);
        if (!first) {
          const float2 o = *p;
          x = make_float2(__fadd_rn(o.x, x.x), __fadd_rn(o.y, x.y));
        }
        *p = x;
      }
      x0 = x1 = 0.f;
    }
  }
}

template <int HDP>
struct Layout2 {                      // dynamic shared memory, from a 1024-aligned base
  static constexpr int kChunks = HDP / 64;
  static constexpr int kv_bytes = kBK2 * HDP * 2;     // resident K; V the same
  static constexpr int t_bytes = kBQ2 * HDP * 2;      // a q stage; a dO stage the same
  static constexpr int st_bytes = 3 * kBQ2 * 4;       // a stage's m, 1/l and D
  static constexpr int p_bytes = 128 * 32 * 4;        // P, from consumer 1 to consumer 2
  static constexpr int k_off = 0;
  static constexpr int v_off = kv_bytes;
  static constexpr int q_off = 2 * kv_bytes;
  static constexpr int g_off = q_off + kStages * t_bytes;
  static constexpr int st_off = g_off + kStages * t_bytes;
  static constexpr int p_off = st_off + kStages * st_bytes;
  static constexpr int bar_off = p_off + p_bytes;
  static constexpr int bytes = bar_off + (1 + 2 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap gmap, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, const float* __restrict__ stats,
                    float* __restrict__ part, const Geometry g) {
  using L = Layout2<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);     // the same base, as a generic pointer
  const uint32_t sK = base + L::k_off, sV = base + L::v_off;
  const uint32_t sQ = base + L::q_off, sG = base + L::g_off, sSt = base + L::st_off;
  const uint32_t kv_full = base + L::bar_off;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kStages + s); };

  const int k0 = blockIdx.x * kBK2, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = g.H / g.KVH;
  // the queries that see these keys; with a window, rows past Sk + window − 1
  // see no key and average them all, so then every later row is walked
  const int k_last = min(k0 + kBK2, g.Sk) - 1;
  int qlo, qhi;
  query_range(g.Sq, g.Sk, g.causal, g.window, g.q_pos0, k0, k_last, qlo, qhi);
  const int qt0 = qlo / kBQ2;
  const int per_head = max(0, (qhi - qt0 * kBQ2 + kBQ2 - 1) / kBQ2);
  const int n_tiles = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    // ---- producer: K and V once, then each visible (head, query tile)'s q,
    // dO and statistics
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kv_bytes);
      for (int c = 0; c < L::kChunks; ++c)
        for (int r = 0; r < kBK2; r += kKBox) {
          tma_load(sK + (c * kBK2 + r) * kRow, &kmap, kv_full, c * 64, k0 + r, kvh, b);
          tma_load(sV + (c * kBK2 + r) * kRow, &vmap, kv_full, c * 64, k0 + r, kvh, b);
        }
      const long long n_rows = static_cast<long long>(g.B) * g.H * g.SqP;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        const int h = kvh * rep + i / per_head, q0 = (qt0 + i % per_head) * kBQ2;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), 2 * L::t_bytes + L::st_bytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(sQ + s * L::t_bytes + c * kBQ2 * kRow, &qmap, full(s), c * 64, q0, h, b);
          tma_load(sG + s * L::t_bytes + c * kBQ2 * kRow, &gmap, full(s), c * 64, q0, h, b);
        }
        const float* st = stats + (static_cast<long long>(b) * g.H + h) * g.SqP + q0;
        for (int j = 0; j < 3; ++j)
          bulk_load(sSt + s * L::st_bytes + j * kBQ2 * 4, st + j * n_rows, kBQ2 * 4, full(s));
      }
    }
    return;
  }

  // ---- consumers: 1 owns dv, 2 owns dk; both cover the block's 64 keys
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, tid = threadIdx.x % 128;
  const int quad = lane % 4;
  const int ka = k0 + warp * 16 + lane / 4, kb = ka + 8;   // the thread's two keys
  float* const Px = reinterpret_cast<float*>(gbase + L::p_off);
  // consumer 1: sᵀ = K·qᵀ, then dv += Pᵀ·dO; consumer 2: dPᵀ = V·dOᵀ, then
  // dk += dSᵀ·q
  const uint32_t sA = cw == 0 ? sK : sV;
  // this consumer's partial sums over the query heads (dv, then dk)
  float* const mine = part == nullptr ? nullptr
                      : part + (cw == 0 ? 0LL : static_cast<long long>(g.B) * g.Sk * g.KVH * g.hd);

  float acc[HDP / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int q0 = (qt0 + i % per_head) * kBQ2;
    const uint32_t sQs = sQ + s * L::t_bytes, sGs = sG + s * L::t_bytes;
    const float* st = reinterpret_cast<const float*>(gbase + L::st_off + s * L::st_bytes);
    mbar_wait(full(s), phase);

    float T[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) T[j] = 0.f;
    {
      const uint32_t sB = cw == 0 ? sQs : sGs;
      fence_regs(T);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t aoff = (kk / 4) * kBK2 * kRow + (kk % 4) * 32;
        const uint32_t boff = (kk / 4) * kBQ2 * kRow + (kk % 4) * 32;
        wgmma_ss_n64(T, smem_desc(sA + aoff, 16, 1024), smem_desc(sB + boff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(T);
    }
    // element j: key (j & 2 ? kb : ka), query tile column ql
    auto col = [&](int j) { return 8 * (j / 4) + 2 * quad + (j & 1); };
    if (cw == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int ql = col(j), qi = q0 + ql, kj = (j & 2) ? kb : ka;
        const float x = is_masked(g, qi, kj) ? kMasked : T[j] * g.scale_log2;
        T[j] = qi < g.Sq && kj < g.Sk ? exp2f(x - st[ql]) * st[kBQ2 + ql] : 0.f;
      }
      if (i > 0) named_sync(2);          // consumer 2 has read the last tile's P
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(Px + (j * 128 + tid) * 4) =
            make_float4(T[4 * j], T[4 * j + 1], T[4 * j + 2], T[4 * j + 3]);
      named_arrive(1);
    } else {
      named_sync(1);                     // consumer 1's P of this tile is in place
      float P[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(Px + (j * 128 + tid) * 4);
        P[4 * j] = p.x;
        P[4 * j + 1] = p.y;
        P[4 * j + 2] = p.z;
        P[4 * j + 3] = p.w;
      }
      named_arrive(2);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int ql = col(j), qi = q0 + ql, kj = (j & 2) ? kb : ka;
        T[j] = qi < g.Sq && kj < g.Sk && !is_masked(g, qi, kj)
                   ? P[j] * (T[j] - st[2 * kBQ2 + ql])
                   : 0.f;
      }
    }
    uint32_t hi[16], lo[16];
    split_bf16(T, hi, lo);
    fence_regs(hi);
    fence_regs(lo);
    product_split<HDP, kBQ2>(acc, hi, lo, cw == 0 ? sGs : sQs, kBQ2);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (i % per_head == per_head - 1 && i + 1 < n_tiles)     // a query head's end
      flush_partial<HDP>(acc, mine, i < per_head, ka, kb, quad, kvh, b, g);
  }
  if (cw == 0 && n_tiles > 0) named_sync(2);   // consumer 2's last arrival
  const bool summed = n_tiles > per_head;      // more than one query head walked

  __nv_bfloat16* const out = cw == 0 ? dv : dk;
  const float mult = cw == 0 ? 1.f : g.scale;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int d = 8 * j + 2 * quad;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kj = half ? kb : ka;
      if (kj >= g.Sk || d >= g.hd) continue;
      const long long at = ((static_cast<long long>(b) * g.Sk + kj) * g.KVH + kvh) * g.hd + d;
      float x0 = acc[4 * j + 2 * half], x1 = acc[4 * j + 2 * half + 1];
      if (summed) {
        const float2 o = *reinterpret_cast<const float2*>(mine + at);
        x0 = __fadd_rn(o.x, x0);
        x1 = __fadd_rn(o.y, x1);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(x0 * mult, x1 * mult);
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, float* part, const Geometry& g, const long long* strides,
           cudaStream_t st, int* launched) {
  constexpr int smem1 = Layout1<HDP>::alloc, smem2 = Layout2<HDP>::alloc;
  static bool opted1 = false, opted2 = false;
  cudaError_t e;
  if ((e = allow_smem(attn_bwd_dq_wgmma<HDP>, smem1, opted1)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = allow_smem(attn_bwd_dkdv_wgmma<HDP>, smem2, opted2)) != cudaSuccess)
    return static_cast<int>(e);
  CUtensorMap qm, km, vm, gm;
  int err = make_map(&qm, q, g.B, g.Sq, g.H, g.hd, strides, kQBox);
  if (!err) err = make_map(&km, k, g.B, g.Sk, g.KVH, g.hd, strides + 4, kKBox);
  if (!err) err = make_map(&vm, v, g.B, g.Sk, g.KVH, g.hd, strides + 8, kKBox);
  if (!err) err = make_map(&gm, dout, g.B, g.Sq, g.H, g.hd, strides + 12, kQBox);
  if (err) return err;
  attn_bwd_dq_wgmma<HDP><<<dim3(g.H, g.B, (g.Sq + kBQ1 - 1) / kBQ1), kThreads, smem1, st>>>(
      qm, km, vm, gm, static_cast<__nv_bfloat16*>(dq), stats, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  attn_bwd_dkdv_wgmma<HDP><<<dim3((g.Sk + kBK2 - 1) / kBK2, g.KVH, g.B), kThreads, smem2, st>>>(
      qm, km, vm, gm, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), stats,
      part, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  return 0;
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, float* stats, float* part, const Geometry& g, const long long* strides,
             cudaStream_t st, int* launched) {
  if (g.hd % 8 != 0 || (g.H > g.KVH && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.hd <= 64)
    return launch<64>(q, k, v, dout, dq, dk, dv, stats, part, g, strides, st, launched);
  if (g.hd <= 128)
    return launch<128>(q, k, v, dout, dq, dk, dv, stats, part, g, strides, st, launched);
  return launch<256>(q, k, v, dout, dq, dk, dv, stats, part, g, strides, st, launched);
}

}  // namespace tc

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

int pad_rows(int Sq) { return (Sq + tc::kPad - 1) / tc::kPad * tc::kPad; }

}  // namespace

// Float32 elements of the workspace a call needs: each query row's m, 1/l
// and D, as three (B, H, Sq padded to 128) arrays.
extern "C" long long flash_attention_bwd_workspace_floats(int B, int Sq, int H) {
  return 3LL * B * H * pad_rows(Sq);
}

// The float32 elements of the partial sums of dv and dk over a KV head's
// query heads (dtype 1 with H > KVH: 2·B·Sk·KVH·hd; else none).
extern "C" long long flash_attention_bwd_partial_floats(int dtype, int B, int Sk, int H, int KVH,
                                                         int hd) {
  return dtype == 1 && H > KVH ? 2LL * B * Sk * KVH * hd : 0;
}

// q and dout (B, Sq, H, hd), k and v (B, Sk, KVH, hd), one type (dtype 0
// float32, 1 bfloat16); strides: 16 element strides, q, k, v, dout each
// (b, s, h, d); bfloat16 takes TMA's layout (see the note above; the caller
// checks it).  dq: contiguous (B, Sq, H, hd); dk, dv: contiguous
// (B, Sk, KVH, hd), all of the input type; ws:
// flash_attention_bwd_workspace_floats(B, Sq, H) float32 elements; part:
// flash_attention_bwd_partial_floats(dtype, B, Sk, H, KVH, hd) of them (null
// when that is 0).  causal
// 0 or 1; window 0 for none; q_pos0 the position of query row 0.  *launched: the CUDA launches made (2).
// Returns the first CUDA error (cudaGetLastError() after each launch), the
// negated CUresult of a tensor map that could not be encoded, or
// cudaErrorInvalidValue for what neither type takes (hd > 256, H not a
// multiple of KVH, a bfloat16 hd that is not a multiple of 8, bfloat16
// grouped heads without `part`).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, void* ws,
                                   void* part, int dtype, int B, int Sq, int Sk, int H, int KVH,
                                   int hd, int causal, int window, int q_pos0,
                                   const long long* strides, void* stream, int* launched) {
  *launched = 0;
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > 256 || B > 65535 ||
      H > 65535 || q_pos0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(ws);
  const double scale = 1.0 / sqrt(static_cast<double>(hd));
  if (dtype == 1) {
    tc::Geometry g;
    g.B = B; g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.hd = hd;
    g.causal = causal; g.window = window; g.q_pos0 = q_pos0; g.SqP = pad_rows(Sq);
    g.scale = static_cast<float>(scale);
    g.scale_log2 = static_cast<float>(1.4426950408889634 * scale);
    return tc::dispatch(q, k, v, dout, dq, dk, dv, stats, static_cast<float*>(part), g, strides,
                        st, launched);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.B = B; g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.hd = hd;
  g.causal = causal; g.window = window; g.q_pos0 = q_pos0;
  g.scale = static_cast<float>(scale);
  for (int i = 0; i < 4; ++i) {
    g.qs[i] = strides[i];
    g.ks[i] = strides[4 + i];
    g.vs[i] = strides[8 + i];
    g.gs[i] = strides[12 + i];
  }
  return dispatch(q, k, v, dout, dq, dk, dv, stats, g, st, launched);
}

// Registers a thread, local (spill) bytes a thread and the largest block of
// launch `which` (0 dq, 1 dk/dv) for (dtype, padded head size): float32
// 32, 64, 128 or 256 (CUDA cores), bfloat16 64, 128 or 256 (wgmma; the
// consumers raise their registers at run time with setmaxnreg).  out: three
// ints.  Returns a CUDA error.
extern "C" int flash_attention_bwd_attributes(int dtype, int hdp, int which, int* out) {
  if (which != 0 && which != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (hdp * 2 + which) {
      case 64: return attributes_of(attn_bwd_dq_kernel<32>, out);
      case 65: return attributes_of(attn_bwd_dkdv_kernel<32>, out);
      case 128: return attributes_of(attn_bwd_dq_kernel<64>, out);
      case 129: return attributes_of(attn_bwd_dkdv_kernel<64>, out);
      case 256: return attributes_of(attn_bwd_dq_kernel<128>, out);
      case 257: return attributes_of(attn_bwd_dkdv_kernel<128>, out);
      case 512: return attributes_of(attn_bwd_dq_kernel<256>, out);
      case 513: return attributes_of(attn_bwd_dkdv_kernel<256>, out);
    }
  } else if (dtype == 1) {
    switch (hdp * 2 + which) {
      case 128: return attributes_of(tc::attn_bwd_dq_wgmma<64>, out);
      case 129: return attributes_of(tc::attn_bwd_dkdv_wgmma<64>, out);
      case 256: return attributes_of(tc::attn_bwd_dq_wgmma<128>, out);
      case 257: return attributes_of(tc::attn_bwd_dkdv_wgmma<128>, out);
      case 512: return attributes_of(tc::attn_bwd_dq_wgmma<256>, out);
      case 513: return attributes_of(tc::attn_bwd_dkdv_wgmma<256>, out);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
