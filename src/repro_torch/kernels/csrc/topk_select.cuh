// Device code shared by the exact |.|-Top-K kernels (topk_threshold.cu,
// topk_compress_sum.cu): block-wide sums and the 31-pass threshold search.
//
// The IEEE-754 pattern of a non-negative float is monotone in its value, so
// the search runs on int32 keys.  31 count passes, one per non-sign bit from
// bit 30 down, greedily build the largest key t with count(key >= t) >= k,
// which is exactly the k-th largest value, ties included.  Counts are
// integers, so the result is exact.
#pragma once

#include <cuda_runtime.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Keys read as they are (rows of non-negative floats).
struct PlainKeys {
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return p[i]; }
};

// Keys of |x|: the sign bit cleared (what fabsf does to the pattern).
struct AbsKeys {
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return p[i] & 0x7fffffff; }
};

// Sum of one unsigned per thread over the block; every thread gets the
// total.  `scratch` holds kWarps entries in shared memory.
__device__ __forceinline__ unsigned block_sum(unsigned c, unsigned* scratch) {
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = c;
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();  // every thread has read scratch before it is written again
  return total;
}

// Exact k-th largest of the T keys `key(0..T-1)`, 1 <= k <= T.  Every
// thread of the block returns the same value.
template <typename Key>
__device__ __forceinline__ int row_threshold(Key key, int T, int k, unsigned* scratch) {
  int t = 0;
  for (int bit = 30; bit >= 0; --bit) {
    const int cand = t | (1 << bit);
    unsigned c = 0;
    for (int i = threadIdx.x; i < T; i += kThreads) c += key(i) >= cand ? 1u : 0u;
    if (block_sum(c, scratch) >= static_cast<unsigned>(k)) t = cand;
  }
  return t;
}

}  // namespace topk
