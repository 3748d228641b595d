// Exact |.|-Top-K of every row of a float32 client stack, fused with the
// sum of the compressed rows over the client axis.
//
// Replaces src/repro/kernels/topk_threshold.py::topk_compress_sum (the
// Pallas kernel `_compress_sum_kernel`).  Contract: `dense` is bitwise the
// two-pass selection (threshold kernel + keep_mask + where), and `col_sum`
// is the sum of the dense rows taken in row order ((0 + row 0) + row 1) +
// ... from +0.0, so it is deterministic and bitwise equal to the plain
// version's row-order sum.
//
// Every row is one 256-thread block, which compresses it into its shared
// memory:
//   - each thread owns a contiguous run of `run` keys, `run` odd, so the 32
//     lanes of a warp touching element j of their runs hit 32 different
//     banks.  Runs of up to 17 keys are loaded straight from global memory
//     into registers (stage kRegisters); longer runs are read from the row
//     staged in shared memory (kShared), as in topk_select.cuh;
//   - the exact k-th largest |v| key t, and k minus the count above it,
//     come from the four-pass radix select of topk_select.cuh;
//   - one block-wide exclusive scan of each thread's count of ties (|v| == t)
//     gives every tie its rank in index order, so the earliest k - above
//     ties are kept: the reference's tie-break;
//   - each thread writes its run to the shared row, dropped entries as +0;
//     after a barrier the block copies the row to `dense`, coalesced.
//
// Two forms behind one entry point; the wrapper's plan
// (topk_threshold.py::compress_sum_plan) chooses, and this file does not
// choose again:
//   1. cluster (n <= 8, the row fits in shared memory) -- ONE launch: the n
//      row blocks are one thread-block cluster.  After a cluster barrier
//      block j sums its slice of `slice_cols` columns over rows 0..n-1 in
//      row order, reading the other blocks' compressed rows through
//      distributed shared memory, and writes col_sum; then it arrives on a
//      second cluster barrier, writes its dense row, and waits there, so
//      that every block's shared memory stays alive until all have read it.
//      `dense` is never read back.
//   2. two launches (n > 8, or a row too long for shared memory, kGlobal):
//      select_rows, one block per row (rows in shared memory as above; a
//      kGlobal row selects from global memory and ranks its ties in
//      256-wide tiles), then column_sums, one thread per column summing
//      `dense` in row order.
//
// Bound on an H100: one read of v and one write of dense (2*n*T*4 bytes)
// plus the T*4-byte sum.  At the BL-DNN path's shapes ((8, 3072) and
// smaller) that is far below a launch's latency; the serial chain of a
// block -- the loads, four select passes of two barriers, the scan, the
// copy out, two cluster barriers -- is what a call costs.  At (512, 16384)
// the column sum reads dense back (a third of the bytes): 32 rows' loads
// are kept in flight a thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kSumThreads = 128;  // column_sums: one thread a column
constexpr int kSumDepth = 32;     // rows whose loads column_sums keeps in flight

// Write the run's compressed elements to shared `row`: the k largest |v|
// of the block's row kept, ties by earliest index, the rest +0.  The caller
// puts a barrier before `row` is read by another thread.
template <class Run>
__device__ __forceinline__ void compress_run(float* row, const Run& keys, int k,
                                             topk::Scratch& s) {
  const topk::Selection sel = topk::radix_select(keys, k, s);
  unsigned ties = 0u;
  keys.each([&](int, int key) { ties += key == sel.t ? 1u : 0u; });
  unsigned rank = topk::block_exclusive_scan(ties, s);   // ties before my run
  float* mine = row + keys.first;
  keys.each([&](int j, int key) {
    if (key == topk::kNoKey) return;
    const bool keep = key > sel.t || (key == sel.t && rank++ < sel.ties);
    mine[j] = keep ? keys.value(j) : 0.0f;
  });
}

// Compress row blockIdx.x of v into shared `row`.  N > 0: runs of up to N
// keys loaded into registers; N == 0: runs read from the row staged in
// shared memory.
template <int N>
__device__ __forceinline__ void compress_row(const float* v, float* row, int T, int k, int run,
                                             topk::Scratch& s) {
  const float* g = v + static_cast<size_t>(blockIdx.x) * T;
  if constexpr (N > 0) {
    compress_run(row, topk::RegisterRun<N, topk::AbsKey>(g, T, run), k, s);
  } else {
    topk::stage_row(row, g, T);
    compress_run(row, topk::SharedRun<topk::AbsKey>(row, T, run), k, s);
  }
}

__device__ __forceinline__ void write_dense(float* dense, const float* row, int T) {
  float* out = dense + static_cast<size_t>(blockIdx.x) * T;
  for (int i = threadIdx.x; i < T; i += topk::kThreads) out[i] = row[i];
}

// The halves of cluster.sync(): arrive (releasing this thread's accesses)
// and wait (acquiring every thread's), so that work can run in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int N>
__global__ void __launch_bounds__(topk::kThreads)
compress_sum_cluster(const float* __restrict__ v, float* __restrict__ dense,
                     float* __restrict__ col_sum, int T, int k, int run, int slice_cols) {
  extern __shared__ __align__(16) float row[];
  __shared__ topk::Scratch scratch;
  cg::cluster_group cluster = cg::this_cluster();
  compress_row<N>(v, row, T, k, run, scratch);
  cluster.sync();   // every block's compressed row is in its shared memory

  // this block's columns, summed over the cluster's rows in row order
  const int n = static_cast<int>(cluster.num_blocks());
  const float* rows[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) rows[q] = cluster.map_shared_rank(row, q < n ? q : 0);
  const int c0 = min(T, static_cast<int>(cluster.block_rank()) * slice_cols);
  const int c1 = min(T, c0 + slice_cols);
  for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += topk::kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < n) acc += rows[q][c];
    }
    col_sum[c] = acc;
  }
  cluster_arrive();            // this block is done reading the others' rows
  write_dense(dense, row, T);  // while the last blocks finish theirs
  cluster_wait();              // no block leaves while another reads its row
}

template <int N>
__global__ void __launch_bounds__(topk::kThreads)
select_rows_staged(const float* __restrict__ v, float* __restrict__ dense, int T, int k,
                   int run) {
  extern __shared__ __align__(16) float row[];
  __shared__ topk::Scratch scratch;
  compress_row<N>(v, row, T, k, run, scratch);
  __syncthreads();
  write_dense(dense, row, T);
}

// A row too long to stage: select from global memory, then walk the row in
// tiles of 256 in index order; a warp ballot and the warp totals give each
// tie its in-order rank, carried across tiles.
__global__ void __launch_bounds__(topk::kThreads)
select_rows_unstaged(const float* __restrict__ v, float* __restrict__ dense, int T, int k) {
  __shared__ topk::Scratch scratch;
  __shared__ unsigned warp_ties[topk::kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * T;
  const float* vr = v + off;
  float* out = dense + off;
  const topk::Selection sel = topk::radix_select(
      topk::StridedKeys<topk::AbsKey>{reinterpret_cast<const int*>(vr), T}, k, scratch);

  unsigned carry = 0;   // ties in earlier tiles
  for (int base = 0; base < T; base += topk::kThreads) {
    const int i = base + tid;
    float x = 0.0f;
    bool gt = false, eq = false;
    if (i < T) {
      x = vr[i];
      const int key = __float_as_int(x) & 0x7fffffff;
      gt = key > sel.t;
      eq = key == sel.t;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) warp_ties[warp] = __popc(ballot);
    __syncthreads();
    unsigned rank = carry + __popc(ballot & ((1u << lane) - 1u));   // ties before i
    unsigned tile = 0;
#pragma unroll
    for (int w = 0; w < topk::kWarps; ++w) {
      const unsigned c = warp_ties[w];
      rank += w < warp ? c : 0u;
      tile += c;
    }
    __syncthreads();   // warp_ties is rewritten by the next tile
    carry += tile;
    if (i < T) out[i] = (gt || (eq && rank < sel.ties)) ? x : 0.0f;
  }
}

// One thread a column, summing `dense` in row order; the loads of
// kSumDepth rows all start before their adds.
__global__ void __launch_bounds__(kSumThreads)
column_sums(const float* __restrict__ dense, float* __restrict__ col_sum, int n, int T) {
  const int c = blockIdx.x * kSumThreads + threadIdx.x;
  if (c >= T) return;
  const float* p = dense + c;
  float s = 0.0f;
  int r = 0;
  for (; r + kSumDepth <= n; r += kSumDepth) {
    float x[kSumDepth];
#pragma unroll
    for (int q = 0; q < kSumDepth; ++q) x[q] = p[static_cast<size_t>(r + q) * T];
#pragma unroll
    for (int q = 0; q < kSumDepth; ++q) s += x[q];
  }
  for (; r < n; ++r) s += p[static_cast<size_t>(r) * T];
  col_sum[c] = s;
}

// Dynamic shared memory above what a block gets without the opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem + sizeof(topk::Scratch) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int N>
cudaError_t launch_cluster(const float* v, float* dense, float* col_sum, int n, int T, int k,
                           int run, int slice_cols, size_t smem, cudaStream_t s) {
  const cudaError_t e = allow_smem(compress_sum_cluster<N>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, 1, 1);
  cfg.blockDim = dim3(topk::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, compress_sum_cluster<N>, v, dense, col_sum, T, k, run,
                            slice_cols);
}

template <int N>
cudaError_t launch_staged(const float* v, float* dense, int n, int T, int k, int run,
                          size_t smem, cudaStream_t s) {
  const cudaError_t e = allow_smem(select_rows_staged<N>, smem);
  if (e != cudaSuccess) return e;
  select_rows_staged<N><<<n, topk::kThreads, smem, s>>>(v, dense, T, k, run);
  return cudaGetLastError();
}

}  // namespace

// v: (n, T) float32, contiguous; dense: (n, T); col_sum: (T,).  k must
// already be clamped to [1, T].  The plan, from the wrapper's
// compress_sum_plan: `cluster` (one cluster launch: n <= 8 and a row that
// reaches shared memory), `stage` and `run` (how a row reaches its block,
// and the keys a thread owns of a row that is not kGlobal; topk_select.cuh),
// `slice_cols` (columns a cluster block sums).  `launches` receives the
// CUDA launches made.  Returns the first CUDA error (cudaErrorInvalidValue
// for a plan it cannot run), else cudaSuccess.
extern "C" int topk_compress_sum_f32(const void* v_, void* dense_, void* col_sum_, int n, int T,
                                     int k, int cluster, int stage, int run, int slice_cols,
                                     void* stream, int* launches) {
  *launches = 0;
  if (n == 0 || T == 0) return static_cast<int>(cudaSuccess);
  const bool staged = stage != topk::kGlobal;
  if (!topk::form_ok(stage, run, T) ||
      (cluster && (!staged || n > kMaxCluster || static_cast<long long>(slice_cols) * n < T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* v = static_cast<const float*>(v_);
  float* dense = static_cast<float*>(dense_);
  float* col_sum = static_cast<float*>(col_sum_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the compressed row lives in shared memory on every staged form
  const size_t smem = staged ? static_cast<size_t>(T) * sizeof(float) : 0;
  cudaError_t e;
  if (cluster) {
    TOPK_DISPATCH_ROW(stage, run, launch_cluster, v, dense, col_sum, n, T, k, run, slice_cols,
                      smem, s)
    if (e == cudaSuccess) *launches = 1;
    return static_cast<int>(e);
  }
  if (staged) {
    TOPK_DISPATCH_ROW(stage, run, launch_staged, v, dense, n, T, k, run, smem, s)
  } else {
    select_rows_unstaged<<<n, topk::kThreads, 0, s>>>(v, dense, T, k);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *launches = 1;
  column_sums<<<(T + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(dense, col_sum, n, T);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launches = 2;
  return static_cast<int>(e);
}
