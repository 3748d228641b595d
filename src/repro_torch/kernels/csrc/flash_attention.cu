// Exact masked softmax attention with an online softmax ("flash" attention),
// grouped-query heads read in place.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel `_flash_kernel`) together with the head folding of
// src/repro/kernels/ops.py::attention: o = softmax(q·kᵀ/√hd + mask)·v with
// the causal mask (k ≤ q) and the sliding-window mask (k > q − window),
// scores masked to −1e30 as the reference does, f32 accumulation and an f32
// running max / denominator / accumulator.
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, KVH, hd), read through element
// strides; query head h reads KV head h / (H / KVH), so neither the head
// transpose nor the KV repeat of ops.attention is materialised.  o is a
// contiguous (B, Sq, H, hd) array of the input type (float32 or bfloat16).
//
// Grid (ceil(Sq / 64), H, B), 256 threads.  A block owns 64 queries of one
// (b, h): their scaled q rows sit in shared memory (head-dim-major), and the
// block walks 64-key tiles.  For each tile it stages K in head-dim chunks of
// 64 and forms the 64 x 64 scores (each thread a 4 x 4 patch), masks them,
// updates the running max and denominator (row reductions over the 16
// threads that share a row), writes the probabilities to shared memory and
// adds P·V from V staged in chunks of keys; each thread keeps a 4-row x
// hd/16-column slice of the output accumulator in registers.  Tiles wholly
// outside the causal / window band are skipped: every row with a visible key
// keeps at least one score above −1e30, so the skipped tiles' weights would
// be wiped by the running max anyway.  A row that sees no key at all (only
// possible with a window when q ≥ Sk + window − 1) gets what the reference
// gives it, the mean of v over every key, because its block then walks every
// tile.  Keys past Sk score −inf and weigh nothing.
//
// Bound on an H100: at the gemma3-4b prefill shapes (B 4, S 2048, 8 query /
// 4 KV heads, hd 256, bf16) a global layer is 6.9e10 operations against
// 50 MB of q, k, v and o: operations, 0.07 ms at the bf16 tensor-core rate.
// This first kernel runs float32 FMAs on the CUDA cores (67 TFLOP/s at
// most); a wgmma / TMA pipeline on the tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, KVH, hd) of one type (dtype 0 float32,
// 1 bfloat16); strides: 12 element strides, (b, s, h, d) of q, k and v;
// o: contiguous (B, Sq, H, hd) of the same type.  window <= 0 means none.
// Returns cudaGetLastError() after the launch (or the shared-memory opt-in's
// error; cudaErrorInvalidValue for hd > 256 or H not a multiple of KVH).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int B, int Sq, int Sk, int H, int KVH, int hd,
                               int causal, int window, const long long* strides,
                               void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.B = B; g.Sq = Sq; g.Sk = Sk; g.H = H; g.KVH = KVH; g.hd = hd;
  g.causal = causal; g.window = window;
  g.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  for (int i = 0; i < 4; ++i) {
    g.qs[i] = strides[i];
    g.ks[i] = strides[4 + i];
    g.vs[i] = strides[8 + i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, g, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
