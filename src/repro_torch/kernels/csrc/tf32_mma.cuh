// Tensor-core float32 products and their operand staging, shared by the SSD
// kernels (ssd_scan.cu, ssd_scan_bwd.cu), for blocks of kTileWarps warps
// (`stage` takes other counts):
// 16-byte (or 4-byte) cp.async staging of strided rows into shared memory,
// and mma.sync m16n8k8 TF32 products of split operands (three TF32 products
// a product: about float32 accuracy).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

constexpr int kTileWarps = 8;   // warps of a block that stages and multiplies

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage dst[r][c] (row stride ldd, a multiple of 4) for r < rows and c <
// cols (a multiple of 4) from src[r·s_row + c·s_col], reading only r <
// row_lim and c < col_lim, zero elsewhere; causal: c ≤ r, zero up to the
// end of r's 16-row tile and nothing written past it (the causal product
// reads a row tile's keys only up to its own end).  Warps take rows, lanes
// 4-column chunks: one 16-byte copy when vec (s_col 1 and every row
// 16-byte aligned), else four 4-byte copies.  kWarps: the block's warps.
template <int kWarps = kTileWarps>
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, long long s_row,
                                      long long s_col, int rows, int row_lim, int cols,
                                      int col_lim, bool vec, bool causal) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    int lim = r < row_lim ? col_lim : 0;
    if (causal && lim > r + 1) lim = r + 1;
    const float* sr = src + r * s_row;
    for (int c = lane * 4; c < cols; c += 128) {
      float* d = dst + r * ldd + c;
      const int n = max(0, min(4, lim - c));     // real elements of the chunk
      if (vec) {
        cp_async16(d, n > 0 ? sr + c : src, n);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) cp_async4(d + j, j < n ? sr + (c + j) * s_col : src, j < n);
      }
    }
  }
}

// a = hi + lo with hi = a truncated to TF32 (its top 19 bits) and lo = a − hi
// exactly; the tensor core reads lo's top 19 bits, so lo·b errs by < 2⁻²⁰|a·b|.
// Bit masks, not cvt.rna.tf32 (a conversion-pipe instruction, 4 a product).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp, two 16-row tiles sharing every B fragment: acc0[j] (rows
// r0.., columns c0 + 8j..) += Σ_{k < k0end} A(r, k) B(k, c), acc1[j] (rows
// r1..) the same over k < k1end (k0end ≤ k1end, multiples of 8; k0end 0
// leaves acc0 alone), in split TF32.  A(r, k) = A[r·lda + k], or
// A[k·lda + r] when AT; B(k, c) = B[k·ldb + c], or B[c·ldb + k] when BT.
// Fragment layouts of m16n8k8 (PTX ISA): lane = 4g + t; a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g);
// d0/d1 (g, 2t / 2t + 1), d2/d3 (g + 8, 2t / 2t + 1).  Row strides ≡ 4
// (mod 32) for a row-major A and a column-major B, ≡ 8 for the others,
// keep the fragment loads free of bank conflicts.
template <int NT, bool AT, bool BT>
__device__ __forceinline__ void mma3x2(float (&acc0)[NT][4], float (&acc1)[NT][4],
                                       const float* A, int lda, const float* B, int ldb,
                                       int r0, int r1, int c0, int k0end, int k1end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto frag = [&](int r, int k, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    float av[4];
    if constexpr (AT) {
      av[0] = A[(k + t) * lda + r + g];
      av[1] = A[(k + t) * lda + r + g + 8];
      av[2] = A[(k + t + 4) * lda + r + g];
      av[3] = A[(k + t + 4) * lda + r + g + 8];
    } else {
      av[0] = A[(r + g) * lda + k + t];
      av[1] = A[(r + g + 8) * lda + k + t];
      av[2] = A[(r + g) * lda + k + t + 4];
      av[3] = A[(r + g + 8) * lda + k + t + 4];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], hi[i], lo[i]);
  };
  for (int k = 0; k < k1end; k += 8) {
    const bool both = k < k0end;
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    frag(r1, k, ah1, al1);
    if (both) frag(r0, k, ah0, al0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = c0 + 8 * j + g;
      const float b0 = BT ? B[c * ldb + k + t] : B[(k + t) * ldb + c];
      const float b1 = BT ? B[c * ldb + k + t + 4] : B[(k + t + 4) * ldb + c];
      uint32_t bh[2], bl[2];
      split_tf32(b0, bh[0], bl[0]);
      split_tf32(b1, bh[1], bl[1]);
      mma_tf32(acc1[j], al1, bh);
      mma_tf32(acc1[j], ah1, bl);
      mma_tf32(acc1[j], ah1, bh);
      if (both) {
        mma_tf32(acc0[j], al0, bh);
        mma_tf32(acc0[j], ah0, bl);
        mma_tf32(acc0[j], ah0, bh);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// A warp's two 16-row tiles of accumulators (rows r0.. and r1..; columns
// c0 + 8j..) into ot[r][c] (row stride lo, even).
__device__ __forceinline__ void park(float* ot, int lo, const float (&acc0)[4][4],
                                     const float (&acc1)[4][4], int r0, int r1, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const float (&acc)[4][4] = side ? acc1 : acc0;
    const int r = side ? r1 : r0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(ot + (r + g) * lo + c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(ot + (r + g + 8) * lo + c) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// dst[r·ld + c] = ot[r][c] for r < rows, c < cols: warps take rows, lanes
// 4-column chunks, 16-byte stores when vec (ld, dst and lo multiples of 4).
__device__ __forceinline__ void unpark(float* dst, long long ld, const float* ot, int lo,
                                       int rows, int cols, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kTileWarps) {
    float* d = dst + r * ld;
    const float* o = ot + r * lo;
    for (int c = lane * 4; c < cols; c += 128) {
      if (vec && c + 4 <= cols) {
        *reinterpret_cast<float4*>(d + c) = *reinterpret_cast<const float4*>(o + c);
      } else {
        for (int j = 0; j < 4 && c + j < cols; ++j) d[c + j] = o[c + j];
      }
    }
  }
}

}  // namespace tf32mma
