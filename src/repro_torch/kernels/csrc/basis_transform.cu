// Two-sided basis transform over a client stack: out[i] = (A . g[i]) . B.
//
// Replaces src/repro/kernels/basis_transform.py::basis_transform (the
// Pallas kernel `_transform_kernel`), associated the same way: the (rows,
// d2) product A . g[i] is formed first, rounded to float32, and then
// multiplied by B.  A is (da, d1), read row-major or, with `a_trans`, from
// the row-major storage of its transpose (d1, da), so a caller passing
// U.mT needs no copy; g is (n, d1, d2), B (d2, db), out (n, da, db), all
// float32 and contiguous.
//
// Products on the tensor cores as three TF32 products of split operands.
// x = hi + lo, hi = x rounded to TF32 (nearest, ties away: bit 12 carried
// into the kept bits, the low 13 cleared), lo = x − hi exactly, rounded
// the same way; x·y = lo·hi + hi·lo + hi·hi, summed in float32.  Rounding
// both parts (kernel 6 truncates them) keeps the split's error well
// inside the contract of 1e-6·max|ref| against float64, which one TF32
// product alone leaves by ~400x (tests/test_torch_basis_transform.py).
//
// Summation: each 32-deep K-tile is summed in 4 steps of 8 into two fresh
// partials, the small products (lo·hi, hi·lo) in one and hi·hi in the
// other, and acc += big + small closes the K-tile, in K order.  The tensor
// core rounds its own sums, so a long running sum inside it would drift:
// this way its rounding acts on the big partial 4 times a K-tile.  A
// product deeper than kCompensateK is compensated instead: `small` runs
// over the whole K, and each K-tile closes with acc + big as a Fast2Sum
// whose rounding error joins `small`; the output is acc + small.  A plain
// float32 sum of K-tiles drifts as their square root: within the 1e-6
// float64 contract at 1024 (32 K-tiles), 2.4e-6 of max|ref| at 32768 (an
// LM's 32768² basis factor).  The compensated form costs registers (it
// spills) and adds, so shorter products keep the plain sum.  Both forms do
// exactly this arithmetic (they agree bitwise), and
// `basis_transform.basis_transform_emulated` repeats it in PyTorch.
//
// Two forms, chosen by the Python plan (`basis_transform.plan`):
//
//  * basis_transform_fused — one launch, grid (ceil(da / 16), n), 4 warps,
//    mma.sync m16n8k8.  A block owns one client and 16 rows of A.  Phase 1
//    runs K-tiles of A's rows against g[i]'s columns (32 a pass, a warp's
//    n-tile each) into the 16 x d2 stripe of A . g[i] in shared memory;
//    phase 2 runs K-tiles of B against the stripe and writes out.  The
//    steps of both phases share one ring of 6 stages (every step of three
//    of the four BL-DNN leaves is in flight from the start), and the
//    intermediate never goes to device memory.  The plan picks the loader:
//    TMA (thread 0; 128-byte swizzle, 64-byte for a k-major A) where every
//    width is a multiple of 4 floats and every operand 16-byte aligned,
//    else cp.async into padded tiles, zero-filled at the ragged edges
//    (d2 = 4 or db = 4 pads to the mma's n = 8).
//    Shared memory ~45 KB plus the stripe; a d2 past ~2,900 does not fit
//    and is refused.
//  * basis_transform_tiled — two launches through a float32 workspace T
//    (n, da, ldt) the wrapper allocates: T = A . g[i], then out = T . B.
//    Grid (ceil(N / 128), ceil(M / 128), n), two warpgroups of 64 rows
//    running wgmma m64n128k8 with A from registers and B from shared
//    memory; TMA keeps 4 K-tiles in flight; every thread splits the next
//    K-tile's B into TF32 planes while the current K-tile's wgmmas run.
//    Each operand tile is re-read from L2 by 8 blocks at 1024², against 64
//    row blocks for the fused form's 16 rows.  TMA takes rows of a whole
//    number of 16 bytes only: other widths are refused here (the plan
//    keeps them fused).
//
// Bound on an H100 at (64; 1024² . 1024² . 1024²): 2.75e11 operations,
// 4.1 ms at 67 TFLOP/s in float32, 1.67 ms as three TF32 products at 495
// TFLOP/s.  At the BL-DNN path's shapes (n = 8, widths <= 96) both bounds
// are under 0.1 us and a call costs its launch and one round trip to
// memory; the fused form keeps it to one launch.

#include <cuda.h>   // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBK = 32;       // K depth of a stage and of one summation partial
constexpr int kCompensateK = 1024;   // deeper products sum their K-tiles compensated
constexpr int kRefused = -1;  // returned for a form these shapes cannot take

// A block's output tile (BM x BN), its warps' layout and its ring of
// STAGES K-tiles.  Warp (wm, wn) owns rows wm·16·MT + [0, 16·MT) as MT
// m-tiles and the 8·NT columns from wn·8·NT on as NT n-tiles, interleaved:
// n-tile j's column g is column wn·8·NT + NT·g + j, so a lane's values of
// one row of Y are neighbours.
template <int BM_, int BN_, int WARPS_M, int WARPS_N, int STAGES>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, kWarpsN = WARPS_N, kStages = STAGES;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = BM / 16 / WARPS_M;
  static constexpr int NT = BN / 8 / WARPS_N;
  // staged tile row pitches in floats, multiples of 4 (16-byte copies),
  // chosen so that every fragment load is free of bank conflicts: ≡ 8
  // (mod 32) for a row-major X (8-byte loads), ≡ 4 (mod 16) for a k-major
  // X and for Y (rows 2t apart)
  static constexpr int kXRowPitch = kBK + 8;
  static constexpr int kXColPitch = BM + 4;
  static constexpr int kYPitch = BN + 4;
  static constexpr int kXFloats =
      BM * kXRowPitch > kBK * kXColPitch ? BM * kXRowPitch : kBK * kXColPitch;
  static constexpr int kStageFloats = kXFloats + kBK * kYPitch;
  static constexpr int kRingBytes = STAGES * kStageFloats * 4;
};
// the fused form: 16 rows, 4 warps of one n-tile each, 6 stages (every
// step of the path's leaves but (8; 32² · 32×64 · 64²)'s in flight at once)
using Fused = Shape<16, 32, 1, 4, 6>;

constexpr int kSmemMax = 227 * 1024;

// the fused stripe's row pitch: d2 in whole passes, + 8 (≡ 8 mod 32)
__host__ __device__ inline int stripe_pitch(int d2) {
  return (d2 + Fused::BN - 1) / Fused::BN * Fused::BN + 8;
}
inline long long fused_smem_bytes(int d2) {
  return 1024 + Fused::kRingBytes + 4LL * Fused::BM * stripe_pitch(d2) + 8 * Fused::kStages;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(4 * n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
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
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// a box of a 3-d (inner, rows, batch) map at coordinates (c0, c1, c2)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// dst[r·ldd + c] for r < rows and c < cols (a multiple of 4) from src[r·ld
// + c], read only where r < rlim and c < clim, zero elsewhere, by the NT
// threads tid = 0 .. NT − 1.  One 16-byte copy a 4-float chunk when vec (ld
// a multiple of 4, src 16-byte aligned), else four 4-byte copies.
template <int NT>
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, long long ld,
                                      int rows, int rlim, int cols, int clim, bool vec,
                                      int tid) {
  const int chunks = cols / 4;
  for (int idx = tid; idx < rows * chunks; idx += NT) {
    const int r = idx / chunks, c = (idx - r * chunks) * 4;
    float* d = dst + r * ldd + c;
    const int live = r < rlim ? max(0, min(4, clim - c)) : 0;
    const float* s = live > 0 ? src + r * ld + c : src;
    if (vec) {
      cp_async16(d, s, live);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(d + j, j < live ? s + j : src, j < live);
    }
  }
}

// x = hi + lo: hi is x rounded to TF32, nearest with ties away from zero (as
// cvt.rna.tf32: bit 12 carried into the kept bits, the low 13 cleared), lo
// = x − hi exactly, given with the same carry; the tensor core reads only
// an operand's top 19 bits, so it takes lo rounded alike
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc + x as a Fast2Sum: acc takes the rounded sum, err adds its rounding
// error (exact while |acc| ≥ |x|, the usual case past the first K-tiles;
// no worse than the plain sum otherwise)
__device__ __forceinline__ void fast_two_sum(float& acc, float x, float& err) {
  const float s = __fadd_rn(acc, x);
  err = __fadd_rn(err, __fsub_rn(x, __fsub_rn(s, acc)));
  acc = s;
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

// One K-tile of `ksteps` steps of 8 (FULL: 4, so that every load can be
// hoisted) into fresh partials: the small products (lo·hi, hi·lo) into
// `small`, the big ones (hi·hi) into `big`, then acc += big + small; with
// `comp`, `small` runs on and acc + big is a Fast2Sum into it.
// X(r, k) = X[r·ldx + k], or X[k·ldx + r] when XT; Y(k, c) = Y[k·ldy + c];
// with XS / YS, X / Y is a TMA box in the swizzle it was loaded with.
// The warp's m-tile i covers rows row0 + 16i, its n-tiles the 8·NT columns
// from wc0 (see Shape).  Fragment layouts of m16n8k8 (PTX ISA): lane = 4g +
// t; a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g),
// b1 (t + 4, g).  Within a step, slot t holds k + 2t and slot t + 4 holds
// k + 2t + 1 for both operands (the step's sum is the same), so a lane's
// a0/a2 of a row-major X are one 8-byte load.  Keeping the small products
// apart means the tensor core's own rounding acts on the big sum only 4
// times a K-tile.
template <class S, bool XT, bool FULL, bool XS, bool YS>
__device__ __forceinline__ void ktile(float (&acc)[S::MT][S::NT][4],
                                      float (&small)[S::MT][S::NT][4], bool comp, const float* X,
                                      int ldx, const float* Y, int ldy, int row0, int wc0,
                                      int ksteps) {
  static_assert(!(XS && XT) || S::BM == 16, "a k-major box has 64-byte rows");
  // element offsets in a staged tile: pitched, or a TMA box in the swizzle
  // the box was loaded with (16-byte chunk index XOR row bits)
  auto xo = [&](int r, int k) {
    if constexpr (XT)
      return XS ? k * S::BM + 4 * ((r >> 2) ^ ((k >> 1) & 3)) + (r & 3) : k * ldx + r;
    else
      return XS ? r * kBK + 4 * ((k >> 2) ^ (r & 7)) + (k & 3) : r * ldx + k;
  };
  auto yo = [&](int k, int c) {
    return YS ? k * kBK + 4 * ((c >> 2) ^ (k & 7)) + (c & 3) : k * ldy + c;
  };
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float big[S::MT][S::NT][4];
  if (!comp) zero(small);
  zero(big);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (!FULL && s >= ksteps) break;
    const int k = 8 * s + 2 * t;
    uint32_t ah[S::MT][4], al[S::MT][4];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      const int r = row0 + 16 * i + g;
      float v[4];
      if constexpr (XT) {
        v[0] = X[xo(r, k)];
        v[1] = X[xo(r + 8, k)];
        v[2] = X[xo(r, k + 1)];
        v[3] = X[xo(r + 8, k + 1)];
      } else {   // (r, k) and (r, k + 1) are neighbours in either layout
        const float2 u0 = *reinterpret_cast<const float2*>(X + xo(r, k));
        const float2 u1 = *reinterpret_cast<const float2*>(X + xo(r + 8, k));
        v[0] = u0.x; v[1] = u1.x; v[2] = u0.y; v[3] = u1.y;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], ah[i][q], al[i][q]);
    }
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      const int c = wc0 + S::NT * g + j;
      uint32_t bh0, bl0, bh1, bl1;
      split(Y[yo(k, c)], bh0, bl0);
      split(Y[yo(k + 1, c)], bh1, bl1);
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        mma(small[i][j], al[i], bh0, bh1);
        mma(small[i][j], ah[i], bl0, bl1);
        mma(big[i][j], ah[i], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (comp)
          fast_two_sum(acc[i][j][q], big[i][j][q], small[i][j][q]);
        else
          acc[i][j][q] += big[i][j][q] + small[i][j][q];
      }
}

// put(r, c, v) for each row r the lane holds: v its 2·NT values of columns
// c .. c + 2·NT − 1 of the block's tile (d0 of the NT n-tiles, then d1)
template <class S, class F>
__device__ __forceinline__ void store(const float (&acc)[S::MT][S::NT][4], int row0, int wc0,
                                      F put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2 * S::NT];
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        v[j] = acc[i][j][2 * h];
        v[S::NT + j] = acc[i][j][2 * h + 1];
      }
      put(row0 + 16 * i + g + 8 * h, wc0 + 2 * S::NT * t, v);
    }
}

// dst[0 .. W) = v where q < live; 8-byte stores when vec and the W fit
template <int W>
__device__ __forceinline__ void write_row(float* dst, const float (&v)[W], int live, bool vec) {
  static_assert(W % 2 == 0, "a row is written in pairs");
#pragma unroll
  for (int q = 0; q < W; q += 2) {
    if (vec && live >= q + 2) {
      *reinterpret_cast<float2*>(dst + q) = make_float2(v[q], v[q + 1]);
    } else {
      if (q < live) dst[q] = v[q];
      if (q + 1 < live) dst[q + 1] = v[q + 1];
    }
  }
}

__device__ __forceinline__ int steps_of(int K, int k0) {   // k-steps of 8 in a K-tile
  return (min(kBK, K - k0) + 7) / 8;
}

struct FusedArgs {
  const float* A;   // (da, d1), or its transpose's (d1, da) storage when AT
  const float* g;
  const float* B;
  float* out;
  int n, da, d1, d2, db;
  int a_vec, g_vec, b_vec, out_vec;
  int tma;   // 1: tiles come by TMA through the maps, 0: by cp.async
};

// The fused form.  With p.tma, thread 0 brings each step's tiles by TMA:
// A's box (16 rows x 32 k in 128-byte swizzle; k-major: 32 k x 16 rows in
// 64-byte swizzle) and gᵢ's or B's (32 k x 32 columns, 128-byte swizzle),
// each stage 1024-byte aligned; else every thread copies them by cp.async
// into pitched tiles (odd widths, operands not 16-byte aligned).
template <bool AT>
__global__ void __launch_bounds__(Fused::kThreads)
basis_transform_fused(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap bmap, const FusedArgs p) {
  using S = Fused;
  constexpr int W = 2 * S::NT;
  extern __shared__ __align__(16) unsigned char fsmem[];
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(fsmem));
  const uint32_t base = (smem0 + 1023u) & ~1023u;   // TMA's swizzle wants 1024 bytes
  float* smem = reinterpret_cast<float*>(fsmem + (base - smem0));
  float* stripe = smem + S::kStages * S::kStageFloats;   // (16, sp): rows of A . g[i]
  const int sp = stripe_pitch(p.d2);
  const uint32_t bars = base + 4 * (S::kStages * S::kStageFloats + S::BM * sp);
  const int r0 = blockIdx.x * S::BM, rows = min(S::BM, p.da - r0);
  const long long i = blockIdx.y;
  const float* gi = p.g + i * p.d1 * p.d2;
  float* oi = p.out + (i * p.da + r0) * p.db;
  const int kt1 = (p.d1 + kBK - 1) / kBK, kt2 = (p.d2 + kBK - 1) / kBK;
  const int s1 = (sp - 8) / S::BN * kt1;                       // phase-1 steps
  const int steps = s1 + (p.db + S::BN - 1) / S::BN * kt2;
  const int wc0 = (threadIdx.x >> 5) % S::kWarpsN * 8 * S::NT;
  const long long lda = AT ? p.da : p.d1;
  constexpr int kXBox = S::BM * kBK * 4;   // bytes of A's box; the Y box follows it

  auto slot = [&](int s) { return smem + (s % S::kStages) * S::kStageFloats; };
  auto issue = [&](int s) {
    if (s >= steps) return;
    float* xs = slot(s);
    float* ys = xs + (p.tma ? kXBox / 4 : S::kXFloats);
    const bool phase2 = s >= s1;
    const int c0 = (phase2 ? (s - s1) / kt2 : s / kt1) * S::BN;
    const int k0 = (phase2 ? (s - s1) % kt2 : s % kt1) * kBK;
    if (p.tma) {
      if (threadIdx.x != 0) return;
      const uint32_t bar = bars + 8 * (s % S::kStages);
      const uint32_t xd = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
      const uint32_t yd = static_cast<uint32_t>(__cvta_generic_to_shared(ys));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // after the slot's reads
      if (phase2) {
        mbar_expect_tx(bar, 4 * kBK * S::BN);
        tma_load(yd, &bmap, bar, c0, k0, 0);
      } else {
        mbar_expect_tx(bar, kXBox + 4 * kBK * S::BN);
        if (AT)
          tma_load(xd, &amap, bar, r0, k0, 0);
        else
          tma_load(xd, &amap, bar, k0, r0, 0);
        tma_load(yd, &gmap, bar, c0, k0, static_cast<int>(i));
      }
      return;
    }
    if (phase2) {
      stage<S::kThreads>(ys, S::kYPitch, p.B + static_cast<long long>(k0) * p.db + c0, p.db,
                         kBK, p.d2 - k0, S::BN, p.db - c0, p.b_vec, threadIdx.x);
      return;
    }
    if (AT)
      stage<S::kThreads>(xs, S::kXColPitch, p.A + k0 * lda + r0, lda, kBK, p.d1 - k0, S::BM,
                         rows, p.a_vec, threadIdx.x);
    else
      stage<S::kThreads>(xs, S::kXRowPitch, p.A + r0 * lda + k0, lda, S::BM, rows, kBK,
                         p.d1 - k0, p.a_vec, threadIdx.x);
    stage<S::kThreads>(ys, S::kYPitch, gi + static_cast<long long>(k0) * p.d2 + c0, p.d2, kBK,
                       p.d1 - k0, S::BN, p.d2 - c0, p.g_vec, threadIdx.x);
  };
  float acc[S::MT][S::NT][4], small[S::MT][S::NT][4];
  // one step's K-tile into acc (and small); XS / YS: X / Y is a TMA box
  auto compute = [&](auto xs_tag, auto ys_tag, bool phase2, const float* X, int ldx,
                     const float* Y, int ldy, int ksteps, bool comp) {
    constexpr bool XS = decltype(xs_tag)::value, YS = decltype(ys_tag)::value;
    if (phase2 && ksteps == 4)
      ktile<S, false, true, XS, YS>(acc, small, comp, X, ldx, Y, ldy, 0, wc0, 4);
    else if (phase2)
      ktile<S, false, false, XS, YS>(acc, small, comp, X, ldx, Y, ldy, 0, wc0, ksteps);
    else if (ksteps == 4)
      ktile<S, AT, true, XS, YS>(acc, small, comp, X, ldx, Y, ldy, 0, wc0, 4);
    else
      ktile<S, AT, false, XS, YS>(acc, small, comp, X, ldx, Y, ldy, 0, wc0, ksteps);
  };

  if (p.tma && threadIdx.x == 0) {
    for (int d = 0; d < S::kStages; ++d) mbar_init(bars + 8 * d, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  zero(acc);
  zero(small);
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (p.tma)
      mbar_wait(bars + 8 * (s % S::kStages), (s / S::kStages) & 1);
    else
      cp_async_wait<S::kStages - 2>();   // this thread's copies of step s landed
    __syncthreads();                     // everyone's; every warp is done with step s − 1
    issue(s + S::kStages - 1);
    cp_async_commit();
    // step s: K-tile kt of pass c (columns c0 ..) of phase 1 or phase 2
    const bool phase2 = s >= s1;
    const int c = phase2 ? (s - s1) / kt2 : s / kt1, kt = phase2 ? (s - s1) % kt2 : s % kt1;
    const int c0 = c * S::BN, kts = phase2 ? kt2 : kt1;
    if (wc0 >= (phase2 ? p.db : p.d2) - c0) continue;   // no live column in this warp
    const float* X = phase2 ? stripe + kt * kBK : slot(s);
    const float* Y = slot(s) + (p.tma ? kXBox / 4 : S::kXFloats);
    const int ksteps = steps_of(phase2 ? p.d2 : p.d1, kt * kBK);
    const bool comp = (phase2 ? p.d2 : p.d1) > kCompensateK;
    using T = std::true_type;
    using F = std::false_type;
    if (phase2 && p.tma)
      compute(F(), T(), true, X, sp, Y, kBK, ksteps, comp);
    else if (phase2)
      compute(F(), F(), true, X, sp, Y, S::kYPitch, ksteps, comp);
    else if (p.tma)
      compute(T(), T(), false, X, 0, Y, kBK, ksteps, comp);
    else
      compute(F(), F(), false, X, AT ? S::kXColPitch : S::kXRowPitch, Y, S::kYPitch, ksteps,
              comp);
    if (kt < kts - 1) continue;
    if (comp) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = __fadd_rn(acc[i][j][q], small[i][j][q]);
    }
    if (phase2)
      store<S>(acc, 0, wc0, [&](int r, int cc, const float (&v)[W]) {
        if (r < rows)
          write_row(oi + static_cast<long long>(r) * p.db + c0 + cc, v, p.db - c0 - cc,
                    p.out_vec);
      });
    else
      store<S>(acc, 0, wc0, [&](int r, int cc, const float (&v)[W]) {
        write_row(stripe + r * sp + c0 + cc, v, W, true);
      });
    zero(acc);
    zero(small);
  }
}

struct TiledArgs {
  const float* X;   // (M, K) rows of ldx, or its transpose's (K, M) storage when XT
  long long ldx, sx;
  const float* Y;   // (K, N) rows of ldy
  long long ldy, sy;
  float* C;         // (M, N) rows of ldc
  long long ldc, sc;
  int M, N, K;
  int c_vec;   // C's rows take 8-byte stores
};

// the tiled form: 128 x 128 output tiles, two warpgroups of 64 rows.  TMA
// brings each K-tile's X box (128 rows x 32 k, 128-byte swizzle; k-major
// X: 32 x 128, plain) and Y box (32 k x 128 n, plain) into a ring of
// kTStages slots; every thread splits Y into one of two buffers of TF32
// planes (hi and lo), each 128 rows (n) of 32 K-major floats in wgmma's
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r mod 8)), a
// step's 8 k in the fragment's slot order (k + 2t at slot t, k + 2t + 1 at
// slot t + 4); each warp splits its 16 rows of X into A fragments in
// registers.
constexpr int kTM = 128, kTN = 128, kTThreads = 256, kTStages = 4;
constexpr int kBoxBytes = kTM * kBK * 4;                   // an X box, a Y box, a plane
constexpr int kRawOff = 4 * kBoxBytes;                     // after the two plane buffers
constexpr int kBarOff = kRawOff + kTStages * 2 * kBoxBytes;
constexpr int kTiledSmem = 1024 + kBarOff + kTStages * 8;

// wgmma shared-memory descriptor: 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// d (64 x 128 f32) {+}= A·B: A (64 x 8) TF32 in registers, each warp its 16
// rows as an m16n8k8 A fragment; B (128 x 8) TF32 in shared memory, K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// C[z] = X[z] . Y[z] (batch strides sx, sy, sc; 0 broadcasts an operand),
// grid (ceil(N / 128), ceil(M / 128), batch).  K-tile s lives in ring slot
// s mod kTStages and plane buffer s mod 2; thread 0 keeps kTStages K-tiles
// of TMA loads in flight.  Each warpgroup runs 4 steps of wgmma m64n128k8
// against the planes: lo·hi and hi·lo into `small`, hi·hi into `big` (both
// fresh each K-tile, then acc += big + small; COMP, for K past
// kCompensateK: `small` runs on and acc + big is a Fast2Sum into it) —
// the fused form's arithmetic, step for step — while every thread splits
// K-tile s + 1's Y into the other plane buffer.
template <bool XT, bool COMP>
__global__ void __launch_bounds__(kTThreads, 1)
basis_transform_tiled(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap ymap, const TiledArgs p) {
  extern __shared__ __align__(16) unsigned char tsmem[];
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(tsmem));
  const uint32_t planes = (smem0 + 1023u) & ~1023u;   // swizzle atoms are 1024 bytes
  const unsigned char* gbase = tsmem + (planes - smem0);
  const uint32_t bars = planes + kBarOff;
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM;
  const int z = blockIdx.z, zx = p.sx ? z : 0, zy = p.sy ? z : 0;
  const int steps = (p.K + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;   // this lane's first row
  auto xraw = [&](int s) { return kRawOff + (s % kTStages) * 2 * kBoxBytes; };
  auto load = [&](int s) {   // thread 0: K-tile s into its slot
    if (s >= steps) return;
    const uint32_t bar = bars + 8 * (s % kTStages), dst = planes + xraw(s);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // after the slot's reads
    mbar_expect_tx(bar, 2 * kBoxBytes);
    if (XT)
      tma_load(dst, &xmap, bar, m0, s * kBK, zx);
    else
      tma_load(dst, &xmap, bar, s * kBK, m0, zx);
    tma_load(dst + kBoxBytes, &ymap, bar, n0, s * kBK, zy);
  };
  auto ready = [&](int s) { mbar_wait(bars + 8 * (s % kTStages), (s / kTStages) & 1); };
  auto convert = [&](int s) {   // Y of K-tile s into plane buffer s mod 2
    const float* ys = reinterpret_cast<const float*>(gbase + xraw(s) + kBoxBytes);
    const uint32_t hi = planes + (s & 1) * 2 * kBoxBytes, lo = hi + kBoxBytes;
    // 16-byte chunk c of plane row n holds k = 8 (c / 2) + 2q + (c mod 2)
    for (int task = threadIdx.x; task < kTN * (kBK / 4); task += kTThreads) {
      const int n = task % kTN, c = task / kTN;
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split(ys[(8 * (c >> 1) + 2 * q + (c & 1)) * kTN + n], h[q], l[q]);
      const uint32_t off = n * 128 + ((c ^ (n & 7)) << 4);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + off), "r"(h[0]),
                   "r"(h[1]), "r"(h[2]), "r"(h[3])
                   : "memory");
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + off), "r"(l[0]),
                   "r"(l[1]), "r"(l[2]), "r"(l[3])
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the wgmmas
  };

  if (threadIdx.x == 0) {
    for (int d = 0; d < kTStages; ++d) mbar_init(bars + 8 * d, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kTStages; ++s) load(s);
  }
  __syncthreads();
  float acc[64], small[64], big[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = small[q] = big[q] = 0.0f;
  ready(0);
  convert(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    // this warp's A fragments of K-tile s, split
    const float* xs = reinterpret_cast<const float*>(gbase + xraw(s));
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 8 * kk + 2 * t;
      float v[4];
      if constexpr (XT) {
        v[0] = xs[k * kTM + rw];
        v[1] = xs[k * kTM + rw + 8];
        v[2] = xs[(k + 1) * kTM + rw];
        v[3] = xs[(k + 1) * kTM + rw + 8];
      } else {   // 128-byte swizzled rows of 32 k
        const int c = (k >> 2) ^ (rw & 7), e = k & 3;
        const float2 u0 = *reinterpret_cast<const float2*>(xs + rw * kBK + 4 * c + e);
        const float2 u1 = *reinterpret_cast<const float2*>(xs + (rw + 8) * kBK + 4 * c + e);
        v[0] = u0.x; v[1] = u1.x; v[2] = u0.y; v[3] = u1.y;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], ah[kk][q], al[kk][q]);
    }
    const uint32_t pb = planes + (s & 1) * 2 * kBoxBytes;
    const int ksteps = (min(kBK, p.K - s * kBK) + 7) / 8;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= ksteps) break;
      const uint64_t yh = smem_desc(pb + kk * 32, 16, 1024);
      const uint64_t yl = smem_desc(pb + kBoxBytes + kk * 32, 16, 1024);
      wgmma_tf32(small, al[kk], yh, COMP || kk > 0);
      wgmma_tf32(small, ah[kk], yl, 1);
      wgmma_tf32(big, ah[kk], yh, kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (s + 1 < steps) {   // the next K-tile's planes, while the wgmmas run
      ready(s + 1);
      convert(s + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(small);
    fence_regs(big);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ah[kk]);
      fence_regs(al[kk]);
    }
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      if constexpr (COMP)
        fast_two_sum(acc[q], big[q], small[q]);
      else
        acc[q] += big[q] + small[q];
    }
    __syncthreads();   // slot s read, planes s + 1 ready, plane buffer s free
    if (threadIdx.x == 0) load(s + kTStages);
  }
  if constexpr (COMP) {
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = __fadd_rn(acc[q], small[q]);
  }
  // accumulator layout of m64nNk8: warp w of the warpgroup, lane 4g + t;
  // acc[4j + 2h + e] at row 16w + g + 8h, column 8j + 2t + e
  float* C = p.C + z * p.sc + m0 * p.ldc + n0;
  const int rows = min(kTM, p.M - m0), cols = min(kTN, p.N - n0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
      write_row(C + r * p.ldc + 8 * j + 2 * t, v, cols - 8 * j - 2 * t, p.c_vec);
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }
bool vec_ok(const void* ptr, long long ld) { return aligned16(ptr) && ld % 4 == 0; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a float32 (inner, rows, batch) map of an array with row stride ld and
// batch stride sb elements (sb 0: one batch entry, broadcast), boxes of
// box_inner x box_rows, `swizzle` bytes of swizzle (0, 64 or 128), zero
// fill outside.  False if TMA cannot take it (a stride or the address not a
// multiple of 16 bytes).
bool make_map(CUtensorMap* map, const float* ptr, int inner, int rows, int batch, long long ld,
              long long sb, int box_inner, int box_rows, int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || !aligned16(ptr) || ld % 4 != 0 || sb % 4 != 0) return false;
  const int nb = sb ? batch : 1;
  // a batch axis of one entry is never stepped: give it any valid stride
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(sb ? sb : ld * rows) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the fused form, tiles by TMA when a.tma (kRefused when TMA cannot take
// an operand), else by cp.async
template <bool AT>
int launch_fused(const FusedArgs& a, long long smem, cudaStream_t stream) {
  using S = Fused;
  CUtensorMap am{}, gm{}, bm{};
  if (a.tma && !((AT ? make_map(&am, a.A, a.da, a.d1, 1, a.da, 0, S::BM, kBK, 64)
                     : make_map(&am, a.A, a.d1, a.da, 1, a.d1, 0, kBK, S::BM, 128)) &&
                 make_map(&gm, a.g, a.d2, a.d1, a.n, a.d2, static_cast<long long>(a.d1) * a.d2,
                          S::BN, kBK, 128) &&
                 make_map(&bm, a.B, a.db, a.d2, 1, a.db, 0, S::BN, kBK, 128)))
    return kRefused;
  static long long opted_in = 48 * 1024;   // the largest shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        basis_transform_fused<AT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = kSmemMax;
  }
  const dim3 grid((a.da + S::BM - 1) / S::BM, a.n);
  basis_transform_fused<AT><<<grid, S::kThreads, static_cast<size_t>(smem), stream>>>(am, gm, bm,
                                                                                       a);
  return static_cast<int>(cudaGetLastError());
}

// kRefused when TMA cannot take an operand
template <bool XT, bool COMP>
int launch_tiled(const TiledArgs& a, int batch, cudaStream_t stream) {
  CUtensorMap xm, ym;
  const bool ok =
      (XT ? make_map(&xm, a.X, a.M, a.K, batch, a.ldx, a.sx, kTM, kBK, 0)
          : make_map(&xm, a.X, a.K, a.M, batch, a.ldx, a.sx, kBK, kTM, 128)) &&
      make_map(&ym, a.Y, a.N, a.K, batch, a.ldy, a.sy, kTN, kBK, 0);
  if (!ok) return kRefused;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        basis_transform_tiled<XT, COMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTiledSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((a.N + kTN - 1) / kTN, (a.M + kTM - 1) / kTM, batch);
  basis_transform_tiled<XT, COMP><<<grid, kTThreads, kTiledSmem, stream>>>(xm, ym, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (n, da, db) = (A . g[i]) . B for A (da, d1) — or, with a_trans, A
// given by the row-major storage of its transpose (d1, da) —, g (n, d1,
// d2), B (d2, db); float32, contiguous.  form 0: the fused form (one
// launch), its tiles by TMA when `tma`, else by cp.async; 1: the two-stage
// form (tma must be 1) through `ws`, a float32 workspace of n · da · ldt
// floats with ldt = d2 rounded up to a multiple of 4 (two launches).
// Returns -1 without a launch for a form these operands cannot take (the
// fused stripe past a block's shared memory; with TMA a width not a
// multiple of 4 floats, an address not 16-byte aligned or no
// cuTensorMapEncodeTiled; a grid axis past its limit), else
// cudaGetLastError() after the last launch (or the first error);
// *launches counts the CUDA launches made.
extern "C" int basis_transform_f32(const void* A, int a_trans, const void* g, const void* B,
                                   void* out, void* ws, int n, int da, int d1, int d2, int db,
                                   int form, int tma, void* stream, int* launches) {
  *launches = 0;
  if (n == 0 || da == 0 || db == 0) return static_cast<int>(cudaSuccess);
  if (n > 65535 || d1 == 0 || d2 == 0) return kRefused;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* gf = static_cast<const float*>(g);
  const float* Bf = static_cast<const float*>(B);
  float* of = static_cast<float*>(out);
  const long long lda = a_trans ? da : d1;
  if (form == 0) {
    const long long smem = fused_smem_bytes(d2);
    if (smem > kSmemMax) return kRefused;
    const FusedArgs p{Af, gf, Bf, of, n, da, d1, d2, db, vec_ok(Af, lda), vec_ok(gf, d2),
                      vec_ok(Bf, db), vec_ok(of, db), tma != 0};
    const int e = a_trans ? launch_fused<true>(p, smem, s) : launch_fused<false>(p, smem, s);
    if (e == 0) *launches = 1;
    return e;
  }
  if (form != 1 || !tma || ws == nullptr || (da + kTM - 1) / kTM > 65535) return kRefused;
  float* T = static_cast<float*>(ws);
  const long long ldt = (d2 + 3) / 4 * 4;
  const TiledArgs first{Af, lda, 0, gf, d2, static_cast<long long>(d1) * d2, T, ldt, da * ldt,
                        da, d2, d1, 1};
  const bool c1 = d1 > kCompensateK, c2 = d2 > kCompensateK;
  int e = a_trans ? (c1 ? launch_tiled<true, true>(first, n, s)
                        : launch_tiled<true, false>(first, n, s))
                  : (c1 ? launch_tiled<false, true>(first, n, s)
                        : launch_tiled<false, false>(first, n, s));
  if (e != 0) return e;
  *launches = 1;
  const TiledArgs second{T, ldt, da * ldt, Bf, db, 0, of, db, static_cast<long long>(da) * db,
                         da, db, d2, vec_ok(of, db)};
  e = c2 ? launch_tiled<false, true>(second, n, s) : launch_tiled<false, false>(second, n, s);
  if (e == 0) *launches = 2;
  return e;
}
