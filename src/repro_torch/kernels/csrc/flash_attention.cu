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

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // queries a block
constexpr int kBK = 64;               // keys a tile
constexpr int kQS = kBQ + 4;          // row stride of the q tile and of P (float4 rows)
constexpr int kKS = kBK + 1;          // row stride of a K chunk (conflict-free transposed stores)
constexpr int kBuf = 64 * kKS;        // floats of the K-chunk / V-chunk buffer (>= 4096)
constexpr float kMasked = -1e30f;     // the reference's masked score

struct Geometry {
  int B, Sq, Sk, H, KVH, hd, causal, window;
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

  // the keys this block's rows can see
  const int q_last = min(q0 + kBQ, g.Sq) - 1;
  int lo = 0, hi = g.Sk;
  if (!(g.window > 0 && q_last >= g.Sk + g.window - 1)) {
    if (g.causal) hi = min(g.Sk, q_last + 1);
    if (g.window > 0) lo = max(0, q0 - g.window + 1);
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
      const int qi = q0 + ty * 4 + r;
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

constexpr int kBQ = 128;              // queries a block: two consumer warpgroups of 64
constexpr int kBK = 64;               // keys a tile
constexpr int kStages = 2;            // K and V ring depth
constexpr int kThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kRow = 128;             // bytes of a swizzled row: 64 bf16 head dims

struct Geometry {
  int Sq, Sk, H, KVH, causal, window;
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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// a plain spin: a timed trap here (a 64-bit %globaltimer loop) made ptxas
// keep the consumers to the launch bound's 168 registers, spilling the
// hd-256 template and serialising its wgmmas
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// a (64-wide head-dim chunk, rows) box of a 4-d (hd, rows, heads, batch) map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(row), "r"(head), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int d, int row,
                                          int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor: 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 f32) {+}= A·B, A and B bf16 in shared memory, both K-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A·B, A bf16 in registers (four 32-bit fragments), B bf16 in
// shared memory, MN-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) += A·B, A bf16 in registers (four 32-bit fragments), B bf16 in
// shared memory, MN-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256 f32) += A·B, A bf16 in registers (four 32-bit fragments), B bf16 in
// shared memory, MN-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&d)[HDP / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HDP == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (HDP == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// the keys [lo, hi) that rows [r0, r_last] can see; every key when the last
// row sees none (the reference's −1e30 rows then average every value)
__device__ __forceinline__ void key_range(const Geometry& g, int r0, int r_last, int& lo,
                                          int& hi) {
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
  const int qa = q0 + row_a, qb = qa + 8;             // its two query rows
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
      const bool edge = (g.causal && k0 + kBK - 1 > w0) ||
                        (g.window > 0 && k0 <= w_last - g.window) || k0 + kBK > g.Sk;
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
        wgmma_pv<HDP>(acc, ah, vd);
        wgmma_pv<HDP>(acc, al, vd);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (hd, rows, heads, batch) bf16 map of a (B, rows, heads, hd) array with
// element strides st (b, s, h, d; d is 1), boxes of 64 head dims x box_rows
// rows, 128-byte swizzle, zero fill outside.  0 on success, else the
// negated CUresult.
int make_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int hd,
             const long long* st, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  // a size-1 dimension's stride is never stepped: give it any valid one
  const long long s_row = rows > 1 ? st[1] : hd, s_head = heads > 1 ? st[2] : hd,
                  s_batch = B > 1 ? st[0] : hd;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KVH, int hd, int causal, int window, const long long* strides,
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
  g.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_kernel_wgmma<HDP><<<grid, kThreads, smem, stream>>>(qm, km, vm, om, g);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
             int KVH, int hd, int causal, int window, const long long* strides,
             cudaStream_t stream) {
  if (hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64) return launch<64>(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, strides, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, strides, stream);
  return launch<256>(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, strides, stream);
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
// o: contiguous (B, Sq, H, hd) of the same type.  window <= 0 means none.
// float32 runs flash_kernel (any strides), bfloat16 flash_kernel_wgmma
// (TMA's layout rules, see the note above; the caller checks them).
// Returns cudaGetLastError() after the launch, or the shared-memory opt-in's
// error, or the negated CUresult of a tensor map that could not be encoded;
// cudaErrorInvalidValue for hd > 256, H not a multiple of KVH, or a bf16 hd
// that is not a multiple of 8.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int Sq, int Sk, int H, int KVH, int hd,
                               int causal, int window, const long long* strides,
                               void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, B, Sq, Sk, H, KVH, hd, causal, window, strides, st);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.B = B; g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.hd = hd;
  g.causal = causal; g.window = window;
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
