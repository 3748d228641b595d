// Device code shared by the exact |.|-Top-K kernels (topk_threshold.cu,
// topk_compress_sum.cu): how a row's keys reach the block, an MSB-first
// radix select of the k-th largest key, and a block-wide exclusive scan.
//
// A row reaches its block one of three ways (the wrapper's `stage`):
//   - kRegisters: each thread loads a contiguous run of `run` keys straight
//     from global memory into registers (`RegisterRun<N>`, N >= run one of
//     kRegisterRuns);
//   - kShared: the block copies the row into shared memory and each thread
//     reads its run there (`SharedRun`).  `run` is odd, so the 32 lanes of
//     a warp reading element j of their runs hit 32 different banks;
//   - kGlobal: a row too long for shared memory; thread i reads keys i,
//     i + 256, ... from global memory (served from L2) on every pass
//     (`StridedKeys`).
//
// The IEEE-754 pattern of a non-negative float is monotone in its value, so
// the select runs on int32 keys in [0, 2^31).  Four passes take the 31
// value bits as digits of 7, 8, 8 and 8 bits, most significant first.  A
// pass counts the keys whose higher digits equal the prefix chosen so far in
// a 256-bin histogram, scans the bins from the top, and takes the digit at
// which the count from the top reaches the k still wanted; the keys in
// higher bins are strictly above the answer, so they leave the count still
// wanted.  After the last digit the prefix is exactly the k-th largest key,
// ties included -- the same answer as a 31-pass bit search -- and what is
// left of k is the number of keys equal to it that the k largest take (k
// minus the keys strictly above it), with no pass of its own.  Counts are
// integers, so the result is exact.
//
// A pass costs two block barriers (histogram done; bin counts scanned):
// every warp then finds the chosen digit by itself from the scanned counts,
// so nothing is broadcast.  Nine barriers for the select, against 62 for a
// bit search.  The histogram is one 256-bin copy per warp, filled by plain
// shared atomics; a warp none of whose lanes still matches the prefix skips
// the atomic.  (Grouping a warp's lanes by digit with __match_any_sync
// before the atomic was slower on the card, ties and all-zero rows
// included.)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;    // one thread a bin when the bins are scanned
constexpr int kPasses = 4;
constexpr int kNoKey = -1;    // a slot that holds no key (every key is >= 0)

// How a row reaches its block, as the wrappers code it.
enum Stage : int { kGlobal = 0, kRegisters = 1, kShared = 2 };
// The register templates: a run of up to N keys a thread (odd, as runs are)
constexpr int kRegisterRuns[] = {1, 5, 9, 13, 17};
constexpr int kMaxRegisterRun = 17;

// Shared memory of the select and of the scan after it.
struct Scratch {
  unsigned hist[kWarps][kBins];   // one sub-histogram a warp
  unsigned suffix[kBins];         // bins b..(end of b's warp of 32 bins)
  unsigned warp_total[kWarps];    // each warp's 32 bins
  unsigned scan_total[kWarps];    // block_exclusive_scan's warp sums
};

struct Selection {
  int t;          // the k-th largest key
  unsigned ties;  // k minus the keys strictly above t: the keys equal to t
                  // that are kept (>= 1)
};

// How a float's raw pattern becomes its key.  PlainKey: the values are
// non-negative, and a negative pattern (-0.0) counts as +0.0, as in the
// plain version's search, which never takes a candidate below 1.  AbsKey:
// the key of |x|, the sign bit cleared (what fabsf does to the pattern).
struct PlainKey {
  static __device__ __forceinline__ int of(int bits) { return max(bits, 0); }
};
struct AbsKey {
  static __device__ __forceinline__ int of(int bits) { return bits & 0x7fffffff; }
};

// A thread's keys, visited by f(j, key) for its slots j = 0, 1, ... in a
// warp-uniform loop: every lane calls f the same number of times, with
// kNoKey for a slot that holds no key, so f may use warp-wide intrinsics.
// A run's value(j) is its j-th element.

// The run [first, first + run) of a row of T, its raw patterns loaded from
// global memory into N >= run registers.
template <int N, class Key>
struct RegisterRun {
  int bits[N];
  int first, valid;
  __device__ __forceinline__ RegisterRun(const float* g, int T, int run)
      : first(static_cast<int>(threadIdx.x) * run), valid(max(0, min(run, T - first))) {
    const int* src = reinterpret_cast<const int*>(g);
#pragma unroll
    for (int j = 0; j < N; ++j) bits[j] = j < valid ? src[first + j] : 0;
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll
    for (int j = 0; j < N; ++j) f(j, j < valid ? Key::of(bits[j]) : kNoKey);
  }
  __device__ __forceinline__ float value(int j) const { return __int_as_float(bits[j]); }
};

// The run read from the row staged in shared memory.
template <class Key>
struct SharedRun {
  const float* row;
  int first, valid, run;
  __device__ __forceinline__ SharedRun(const float* row_, int T, int run_)
      : row(row_), first(static_cast<int>(threadIdx.x) * run_),
        valid(max(0, min(run_, T - first))), run(run_) {}
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int j = 0; j < run; ++j) {
      f(j, j < valid ? Key::of(__float_as_int(row[first + j])) : kNoKey);
    }
  }
  __device__ __forceinline__ float value(int j) const { return row[first + j]; }
};

// Keys i = threadIdx.x + j * kThreads of a row of T in global memory.
template <class Key>
struct StridedKeys {
  const int* p;
  int T;
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int j = 0, i = threadIdx.x; j * kThreads < T; ++j, i += kThreads) {
      f(j, i < T ? Key::of(p[i]) : kNoKey);
    }
  }
};

// Copy the T floats at `g` into shared `row`; every thread returns with the
// row in place.
__device__ __forceinline__ void stage_row(float* row, const float* g, int T) {
  for (int i = threadIdx.x; i < T; i += kThreads) row[i] = g[i];
  __syncthreads();
}

// Exact k-th largest of the keys the block's threads hold (1 <= k <= the
// number of keys), and how many keys equal to it the k largest take.
// Every thread of the block calls it once and gets the same answer.
template <class Keys>
__device__ __forceinline__ Selection radix_select(const Keys& keys, int k, Scratch& s) {
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s.hist[w][tid] = 0u;
  __syncthreads();

  unsigned prefix = 0u, known = 0u;   // the digits chosen, and their bits
  unsigned want = static_cast<unsigned>(k);   // keys still wanted at or below the prefix
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 24 - 8 * pass;   // digits: bits 30-24, 23-16, 15-8, 7-0
    keys.each([&](int, int key) {
      const bool in = key != kNoKey && (static_cast<unsigned>(key) & known) == prefix;
      if (__any_sync(0xffffffffu, in) && in) atomicAdd(&s.hist[warp][(key >> shift) & 0xff], 1u);
    });
    __syncthreads();

    // thread b owns bin b: its count (its bins cleared for the next pass)
    // and the count of bins b..(end of its warp's 32) by a suffix scan
    unsigned from = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      from += s.hist[w][tid];
      s.hist[w][tid] = 0u;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_down_sync(0xffffffffu, from, off);
      if (lane + off < 32) from += y;
    }
    s.suffix[tid] = from;
    if (lane == 0) s.warp_total[warp] = from;
    __syncthreads();

    // every warp alike: the segment of 32 bins that holds the crossing is
    // the last whose count from its first bin upward still reaches `want`;
    // inside it, the crossing bin is the last such bin
    unsigned seg_from = lane < kWarps ? s.warp_total[lane] : 0u;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const unsigned y = __shfl_down_sync(0xffffffffu, seg_from, off);
      if (lane + off < kWarps) seg_from += y;
    }
    const int seg = 31 - __clz(__ballot_sync(0xffffffffu, lane < kWarps && seg_from >= want));
    const unsigned higher_segs = __shfl_sync(0xffffffffu, seg_from, (seg + 1) & 31);
    const unsigned beyond = seg + 1 < kWarps ? higher_segs : 0u;   // bins past the segment
    const unsigned bin_from = s.suffix[seg * 32 + lane] + beyond;
    const int d = 31 - __clz(__ballot_sync(0xffffffffu, bin_from >= want));
    const unsigned next = __shfl_sync(0xffffffffu, bin_from, (d + 1) & 31);
    const unsigned gt = d < 31 ? next : beyond;   // keys in the bins above the crossing
    prefix |= static_cast<unsigned>(seg * 32 + d) << shift;
    known |= 0xffu << shift;
    want -= gt;
  }
  return {static_cast<int>(prefix), want};
}

// Exclusive sum over the block's threads, in thread order, of one count a
// thread.  One barrier; s.scan_total is its own, so it may follow
// radix_select at once.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned c, Scratch& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s.scan_total[warp] = x;
  __syncthreads();
  unsigned before = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s.scan_total[w] : 0u;
  return before + x - c;
}

// Whether (stage, run) is a form the kernels can run on a row of T.
inline bool form_ok(int stage, int run, int T) {
  if (stage == kGlobal) return true;
  if (stage != kRegisters && stage != kShared) return false;
  const bool covers = run % 2 == 1 && static_cast<long long>(run) * kThreads >= T;
  return covers && (stage == kShared || (stage == kRegisters && run <= kMaxRegisterRun));
}

// The template that holds a row of a staged form: N > 0 the register run
// of up to N keys, 0 the row in shared memory.
inline int row_template(int stage, int run) {
  if (stage != kRegisters) return 0;
  for (int N : kRegisterRuns) {
    if (run <= N) return N;
  }
  return 0;
}

}  // namespace topk

// e = LAUNCH<N>(...) for row_template(stage, run).
#define TOPK_DISPATCH_ROW(stage, run, LAUNCH, ...)       \
  switch (topk::row_template(stage, run)) {              \
    case 1: e = LAUNCH<1>(__VA_ARGS__); break;           \
    case 5: e = LAUNCH<5>(__VA_ARGS__); break;           \
    case 9: e = LAUNCH<9>(__VA_ARGS__); break;           \
    case 13: e = LAUNCH<13>(__VA_ARGS__); break;         \
    case 17: e = LAUNCH<17>(__VA_ARGS__); break;         \
    default: e = LAUNCH<0>(__VA_ARGS__); break;          \
  }
