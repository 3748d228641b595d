// Exact masked softmax attention with an online softmax ("flash" attention),
// grouped-query heads read in place.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel `_flash_kernel`) together with the head folding of
// src/repro/kernels/ops.py::attention: o = softmax(q·kᵀ/√hd + mask)·v with
// the causal mask (k ≤ q) and the sliding-window mask (k > q − window),
// scores masked to −1e30 as the reference does, f32 softmax with an f32
// running max and denominator.  Layout: q (B, Sq, H, hd), k and v
// (B, Sk, KVH, hd), read in place; query head h reads KV head h / (H / KVH),
// query row i stands at position q_pos0 + i for the masks (q_pos0 > 0: a
// sequence-parallel rank's slice of the queries against every key),
// so neither the head transpose nor the KV repeat of ops.attention exists.
// o is a contiguous (B, Sq, H, hd) array of the input type.  Tiles wholly
// outside the causal / window band are skipped: every row with a visible
// key keeps a score above −1e30, so a skipped tile's weights would be wiped
// by the running max anyway.  A row that sees no key at all (only with a
// window, when q ≥ Sk + window − 1) gets what the reference gives it, the
// mean of v over every key, because its block then walks every tile.  Keys
// past Sk score −inf and weigh nothing.
//
// Bound on an H100: at the gemma3-4b prefill shapes (B 4, S 2048, 8 query /
// 4 KV heads, hd 256, bf16) a global layer is 6.9e10 operations against
// 50 MB of q, k, v and o, a window-1024 layer 5.2e10: operations, 0.0695 /
// 0.0521 ms at 989 TFLOP/s (bf16 tensor cores).
//
// Two kernels, chosen by the input type:
//
// bfloat16 — flash_kernel_wgmma, designed for Hopper's tensor cores.  Grid
// (H, B, ceil(Sq / 128)), the blocks of the last queries (the longest under
// a causal mask) first.  A block owns 128 queries of one (b, h) and has
// three warpgroups, 384 threads, one block an SM (197 KB of shared memory
// at hd 256: the q tile 64 KB, two K and two V stages of 32 KB).  Warpgroup
// 0 is the producer: it gives up its registers (setmaxnreg 24) and one
// thread keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle, zero fill
// past the tensor's edges) in flight: the q tile once, then 64-key K and V
// tiles through two-stage rings whose full / empty mbarriers hand each
// stage to the consumers and back.  Warpgroups 1 and 2 are the consumers
// (setmaxnreg 240), 64 query rows each: S = q·kᵀ by wgmma from shared
// memory (m64n64k16, f32 accumulators), the mask and the online softmax in
// registers, then o += P·V by wgmma with P from registers and V from
// shared memory (MN-major), o's 64 × hd f32 accumulator held in registers
// for the whole walk.  Each consumer skips the products of tiles outside
// its own rows' band but still takes and releases every stage.  The plain
// version keeps P in f32; one bf16 rounding
// of P errs by up to 2^-9 of the weighted mean |v|, several bf16 ulps of a
// typical output, so P is split: p_hi = bf16(p), p_lo = bf16(p − p_hi),
// and o += p_hi·V + p_lo·V (residual ≈ 2^-17 of mean |v|).  The denominator
// sums the f32 p.  The split makes P·V two products, so the attainable
// floor is about 1.5× the bound.  The epilogue writes o (bf16) into the
// warpgroup's rows of the q tile and stores it with TMA.  Requires unit
// head-dim stride, other strides multiples of 8 elements, 16-byte aligned
// bases and hd a multiple of 8 (TMA's rules); templates for hd ≤ 64, 128,
// 256.
//
// float32 — flash_kernel, CUDA-core FMAs (TF32 stays off), any strides.
// Grid (ceil(Sq / 64), H, B), 256 threads.  A block owns 64 queries of one
// (b, h): their scaled q rows sit in shared memory (head-dim-major), and the
// block walks 64-key tiles.  For each tile it stages K in head-dim chunks of
// 64 and forms the 64 x 64 scores (each thread a 4 x 4 patch), masks them,
// updates the running max and denominator (row reductions over the 16
// threads that share a row), writes the probabilities to shared memory and
// adds P·V from V staged in chunks of keys; each thread keeps a 4-row x
// hd/16-column slice of the output accumulator in registers.

#include <cuda.h>          // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // queries a block
constexpr int kBK = 64;               // keys a tile
constexpr int kQS = kBQ + 4;          // row stride of the q tile and of P (float4 rows)
constexpr int kKS = kBK + 1;          // row stride of a K chunk (conflict-free transposed stores)
constexpr int kBuf = 64 * kKS;        // floats of the K-chunk / V-chunk buffer (>= 4096)
constexpr float kMasked = -1e30f;     // the reference's masked score

struct Geometry {
  int B, Sq, Sk, H, KVH, hd, causal, window, q_pos0;
  float scale;
  long long qs[4], ks[4], vs[4];      // element strides (b, s, h, d)
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int HDP>
constexpr int smem_floats() { return HDP * kQS + kBuf + kBK * kQS; }

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, const Geometry g) {
  constexpr int DC = HDP < 64 ? HDP : 64;                         // head dims a K chunk
  constexpr int KC = (64 * 64) / HDP > kBK ? kBK : (64 * 64) / HDP;  // keys a V chunk
  constexpr int NJ = HDP / 16;                                    // output columns a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HDP][kQS] scaled q, head-dim-major
  float* buf = Qs + HDP * kQS;                   // K chunk [DC][kKS] or V chunk [KC][HDP]
  float* Ps = buf + kBuf;                        // [kBK][kQS] probabilities, key-major

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (g.H / g.KVH);
  const T* qb = q + b * g.qs[0] + h * g.qs[2];
  const T* kb = k + b * g.ks[0] + kvh * g.ks[2];
  const T* vb = v + b * g.vs[0] + kvh * g.vs[2];

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int qi = i / HDP, d = i % HDP;
    float val = 0.f;
    if (q0 + qi < g.Sq && d < g.hd)
      val = to_f(qb[(q0 + qi) * g.qs[1] + d * g.qs[3]]) * g.scale;
    Qs[d * kQS + qi] = val;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }

  // the keys this block's rows (at positions q_pos0 + row) can see
  const int p0 = g.q_pos0 + q0, p_last = g.q_pos0 + min(q0 + kBQ, g.Sq) - 1;
  int lo = 0, hi = g.Sk;
  if (!(g.window > 0 && p_last >= g.Sk + g.window - 1)) {
    if (g.causal) hi = min(g.Sk, p_last + 1);
    if (g.window > 0) lo = max(0, p0 - g.window + 1);
  }

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    // scores s = (q·scale)·kᵀ, a 4 x 4 patch a thread
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int dc = 0; dc < HDP; dc += DC) {
      __syncthreads();
      for (int i = tid; i < kBK * DC; i += kThreads) {
        const int kj = i / DC, dd = i % DC, d = dc + dd;
        float val = 0.f;
        if (k0 + kj < g.Sk && d < g.hd)
          val = to_f(kb[static_cast<long long>(k0 + kj) * g.ks[1] + d * g.ks[3]]);
        buf[dd * kKS + kj] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&Qs[(dc + dd) * kQS + ty * 4]);
        float bj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bj[j] = buf[dd * kKS + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[0][j] = fmaf(a.x, bj[j], s[0][j]);
          s[1][j] = fmaf(a.y, bj[j], s[1][j]);
          s[2][j] = fmaf(a.z, bj[j], s[2][j]);
          s[3][j] = fmaf(a.w, bj[j], s[3][j]);
        }
      }
    }

    // mask, online softmax; s becomes the probabilities
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = g.q_pos0 + q0 + ty * 4 + r;   // the row's position
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[r][j];
        if (kj >= g.Sk)
          x = -INFINITY;
        else if ((g.causal && kj > qi) || (g.window > 0 && kj <= qi - g.window))
          x = kMasked;
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = expf(s[r][j] - m_new);
        sum += s[r][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * kQS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // acc += P·V, V staged KC keys at a time
    for (int kc = 0; kc < kBK; kc += KC) {
      __syncthreads();
      for (int i = tid; i < KC * HDP; i += kThreads) {
        const int kk = i / HDP, d = i % HDP, kj = k0 + kc + kk;
        float val = 0.f;
        if (kj < g.Sk && d < g.hd) val = to_f(vb[static_cast<long long>(kj) * g.vs[1] + d * g.vs[3]]);
        buf[kk * HDP + d] = val;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float4 p = *reinterpret_cast<const float4*>(&Ps[(kc + kk) * kQS + ty * 4]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float vv = buf[kk * HDP + tx + 16 * j];
          acc[0][j] = fmaf(p.x, vv, acc[0][j]);
          acc[1][j] = fmaf(p.y, vv, acc[1][j]);
          acc[2][j] = fmaf(p.z, vv, acc[2][j]);
          acc[3][j] = fmaf(p.w, vv, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= g.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * g.Sq + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.hd) orow[d] = from_f<T>(acc[r][j] / denom);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, const Geometry& g,
           cudaStream_t stream) {
  constexpr int smem = smem_floats<HDP>() * static_cast<int>(sizeof(float));
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((g.Sq + kBQ - 1) / kBQ, g.H, g.B);
  flash_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const Geometry& g,
             cudaStream_t stream) {
  if (g.hd <= 32) return launch<T, 32>(q, k, v, o, g, stream);
  if (g.hd <= 64) return launch<T, 64>(q, k, v, o, g, stream);
  if (g.hd <= 128) return launch<T, 128>(q, k, v, o, g, stream);
  if (g.hd <= 256) return launch<T, 256>(q, k, v, o, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma kernel fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgtma;

constexpr int kBQ = 128;              // queries a block: two consumer warpgroups of 64
constexpr int kBK = 64;               // keys a tile
constexpr int kStages = 2;            // K and V ring depth
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kRow = 128;             // bytes of a swizzled row: 64 bf16 head dims

struct Geometry {
  int Sq, Sk, H, KVH, causal, window, q_pos0;
  float scale_log2;                   // log2(e) / √hd: scores in base 2
};

template <int HDP>
struct Layout {                       // dynamic shared memory, from a 1024-aligned base
  static constexpr int kChunks = HDP / 64;            // 64-wide head-dim chunks a row
  static constexpr int q_bytes = kBQ * HDP * 2;       // q tile (later o's staging)
  static constexpr int kv_bytes = kBK * HDP * 2;      // one K or V stage
  static constexpr int q_off = 0;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  static constexpr int bytes = bar_off + (1 + 4 * kStages) * 8;
  static constexpr int alloc = bytes + 1024;          // slack to align the base
};

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

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, const Geometry g) {
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle atoms are 1024 bytes
  const uint32_t sQ = base + L::q_off, sK = base + L::k_off, sV = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  // the longest blocks (last queries, under a causal mask) start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (g.H / g.KVH);
  int lo, hi;
  key_range(g, q0, min(q0 + kBQ, g.Sq) - 1, lo, hi);
  const int t0 = lo / kBK;
  const int n_tiles = (hi - t0 * kBK + kBK - 1) / kBK;

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

  // the warpgroup's role, warp-uniform by construction (a shuffle from lane
  // 0), so ptxas can give each role its own register budget
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sQ + c * kBQ * kRow, &qmap, q_full, c * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        const int k0 = (t0 + i) * kBK;
        mbar_wait(k_empty(s), phase ^ 1);
        mbar_expect_tx(k_full(s), L::kv_bytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sK + s * L::kv_bytes + c * kBK * kRow, &kmap, k_full(s), c * 64, k0, kvh, b);
        mbar_wait(v_empty(s), phase ^ 1);
        mbar_expect_tx(v_full(s), L::kv_bytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sV + s * L::kv_bytes + c * kBK * kRow, &vmap, v_full(s), c * 64, k0, kvh, b);
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
  const int qa = g.q_pos0 + q0 + row_a, qb = qa + 8;  // its two query rows' positions
  const int w0 = q0 + cw * 64, w_last = min(w0 + 63, g.Sq - 1);
  const bool active = w0 < g.Sq;
  int wlo, whi;
  key_range(g, w0, w_last, wlo, whi);
  const uint32_t sQw = sQ + cw * 64 * kRow;           // the warpgroup's rows of each chunk

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;   // l: this thread's share

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (t0 + i) * kBK;
    const bool work = active && k0 + kBK > wlo && k0 < whi;

    // S = q·kᵀ (64 x 64, f32)
    float S[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) S[j] = 0.f;
    mbar_wait(k_full(s), phase);
    if (work) {
      const uint32_t sKs = sK + s * L::kv_bytes;
      fence_regs(S);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBQ * kRow + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kBK * kRow + (kk % 4) * 32;
        wgmma_ss_n64(S, smem_desc(sQw + off, 16, 1024), smem_desc(sKs + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(S);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(s));

    // mask, online softmax (base 2); S becomes the probabilities
    uint32_t p_hi[16], p_lo[16];
    if (work) {
      const bool edge = (g.causal && k0 + kBK - 1 > g.q_pos0 + w0) ||
                        (g.window > 0 && k0 <= g.q_pos0 + w_last - g.window) ||
                        k0 + kBK > g.Sk;
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = S[j] * g.scale_log2;
        if (edge) {
          const int kj = k0 + 8 * (j / 4) + 2 * quad + (j & 1);
          const int qi = (j & 2) ? qb : qa;
          if (kj >= g.Sk)
            x = -INFINITY;
          else if ((g.causal && kj > qi) || (g.window > 0 && kj <= qi - g.window))
            x = kMasked;
        }
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
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2f(S[j] - ((j & 2) ? m_b : m_a));
        S[j] = p;
        if (j & 2) sum_b += p;
        else sum_a += p;
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) acc[j] *= (j & 2) ? alpha_b : alpha_a;
      // P as wgmma A fragments: key chunk kc, fragment r holds S[8kc + 2r], S[8kc + 2r + 1]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(S[2 * j], S[2 * j + 1]);
        const float2 hf = __bfloat1622float2(hi2);
        p_hi[j] = bf16x2_bits(hi2);
        p_lo[j] = bf16x2_bits(__floats2bfloat162_rn(S[2 * j] - hf.x, S[2 * j + 1] - hf.y));
      }
    }

    // o += p_hi·V + p_lo·V
    mbar_wait(v_full(s), phase);
    if (work) {
      const uint32_t sVs = sV + s * L::kv_bytes;
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        // 16 keys: two 8-row groups 1024 bytes apart; head-dim chunks kBK rows apart
        const uint64_t vd = smem_desc(sVs + kc * 16 * kRow, kBK * kRow, 1024);
        const uint32_t ah[4] = {p_hi[4 * kc], p_hi[4 * kc + 1], p_hi[4 * kc + 2], p_hi[4 * kc + 3]};
        const uint32_t al[4] = {p_lo[4 * kc], p_lo[4 * kc + 1], p_lo[4 * kc + 2], p_lo[4 * kc + 3]};
        wgmma_rs<HDP>(acc, ah, vd);
        wgmma_rs<HDP>(acc, al, vd);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(s));
  }
  if (!active) return;

  // o = acc / l in bf16, written into the warpgroup's rows of the q tile in
  // the swizzled layout TMA reads, then stored by TMA (rows ≥ Sq and head
  // dims ≥ hd fall outside the map and are not written)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      const float inv = half ? inv_b : inv_a;
      const uint32_t addr = sQ + (j / 8) * kBQ * kRow + row * kRow +
                            (((j % 8) ^ (row % 8)) * 16) + quad * 4;
      const uint32_t val = bf16x2_bits(
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv));
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(val) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < L::kChunks; ++c) tma_store(&omap, sQw + c * kBQ * kRow, c * 64, w0, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KVH, int hd, int causal, int window, int q_pos0, const long long* strides,
           cudaStream_t stream) {
  constexpr int smem = Layout<HDP>::alloc;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  CUtensorMap qm, km, vm, om;
  const long long os[4] = {static_cast<long long>(Sq) * H * hd, static_cast<long long>(H) * hd,
                           hd, 1};
  int err = make_map(&qm, q, B, Sq, H, hd, strides, kBQ);
  if (!err) err = make_map(&km, k, B, Sk, KVH, hd, strides + 4, kBK);
  if (!err) err = make_map(&vm, v, B, Sk, KVH, hd, strides + 8, kBK);
  if (!err) err = make_map(&om, o, B, Sq, H, hd, os, 64);
  if (err) return err;
  Geometry g;
  g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.causal = causal; g.window = window;
  g.q_pos0 = q_pos0;
  g.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_kernel_wgmma<HDP><<<grid, kThreads, smem, stream>>>(qm, km, vm, om, g);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
             int KVH, int hd, int causal, int window, int q_pos0, const long long* strides,
             cudaStream_t stream) {
  if (hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch<64>(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, q_pos0, strides, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, q_pos0, strides, stream);
  return launch<256>(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, q_pos0, strides, stream);
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

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, KVH, hd) of one type (dtype 0 float32,
// 1 bfloat16); strides: 12 element strides, (b, s, h, d) of q, k and v;
// o: contiguous (B, Sq, H, hd) of the same type.  window <= 0 means none;
// q_pos0: the position of query row 0 (rows at q_pos0 + i for the masks).
// float32 runs flash_kernel (any strides), bfloat16 flash_kernel_wgmma
// (TMA's layout rules, see the note above; the caller checks them).
// Returns cudaGetLastError() after the launch, or the shared-memory opt-in's
// error, or the negated CUresult of a tensor map that could not be encoded;
// cudaErrorInvalidValue for hd > 256, H not a multiple of KVH, or a bf16 hd
// that is not a multiple of 8.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int Sq, int Sk, int H, int KVH, int hd,
                               int causal, int window, int q_pos0,
                               const long long* strides, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > 256 || q_pos0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, q_pos0, strides,
                        st);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.B = B; g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.hd = hd;
  g.causal = causal; g.window = window; g.q_pos0 = q_pos0;
  g.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  for (int i = 0; i < 4; ++i) {
    g.qs[i] = strides[i];
    g.ks[i] = strides[4 + i];
    g.vs[i] = strides[8 + i];
  }
  return dispatch<float>(q, k, v, o, g, st);
}

// Registers a thread, local (spill) bytes a thread and the largest block of
// the template for (dtype, padded head size): float32 hdp 32, 64, 128 or
// 256; bfloat16 hdp 64, 128 or 256.  out: three ints.  Returns a CUDA error.
extern "C" int flash_attention_attributes(int dtype, int hdp, int* out) {
  if (dtype == 0) {
    if (hdp == 32) return attributes_of(flash_kernel<float, 32>, out);
    if (hdp == 64) return attributes_of(flash_kernel<float, 64>, out);
    if (hdp == 128) return attributes_of(flash_kernel<float, 128>, out);
    if (hdp == 256) return attributes_of(flash_kernel<float, 256>, out);
  } else if (dtype == 1) {
    if (hdp == 64) return attributes_of(tc::flash_kernel_wgmma<64>, out);
    if (hdp == 128) return attributes_of(tc::flash_kernel_wgmma<128>, out);
    if (hdp == 256) return attributes_of(tc::flash_kernel_wgmma<256>, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
