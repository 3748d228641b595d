"""Exact |·|-Top-K threshold selection: the CUDA kernels and their plain
versions.

Port of `repro.kernels.topk_threshold` (``topk_row_threshold`` and
``keep_mask``).  Per row of non-negative float32 values the threshold is
the EXACT k-th largest, taken on the int32 bit patterns (monotone in value
for non-negative floats), so it equals ``torch.topk(a, k).values[..., -1:]``
bit for bit and the shared tie-break `keep_mask` keeps exactly k entries per
row.

`topk_row_threshold` launches the hand-written kernel
(``csrc/topk_threshold.cu``) on a CUDA tensor and takes the plain PyTorch
version, `topk_row_threshold_plain` (the reference's 31-pass bit search),
only for a tensor on the CPU.  The kernel finds the same key by a four-pass
radix select (``csrc/topk_select.cuh``); `topk_row_threshold_radix_emulated`
is that arithmetic in PyTorch, for the tests and the card's checks; no path
runs it.  `keep_mask` runs outside the kernel in the reference too, so it
stays plain PyTorch here.

`topk_threshold` is the reference's global Top-K over a whole tensor: the
tensor flattened to one row, its threshold from `topk_row_threshold`
(the kernel on a CUDA tensor) and `keep_mask`'s exactly-k selection.

`topk_compress_sum` is the fused codec of the reference's Fisher leg: the
same selection applied to every row of a signed (n, T) client stack, the
dense kept values, and their sum over the client axis in row order
(``csrc/topk_compress_sum.cu``; plain version `topk_compress_sum_plain`).
`compress_sum_plan` chooses its form: one cluster launch whose blocks sum
the columns through distributed shared memory, or a selection launch and a
column-sum launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from ._autograd import refuse_grad

#: launches of the threshold kernel since the last reset (the plain version
#: on a CPU tensor does not count)
launches = 0
#: calls of the fused compress-sum kernel, counted the same way
compress_sum_launches = 0
#: CUDA launches those calls made (`CompressSumPlan.launches` each)
compress_sum_cuda_launches = 0

#: the threshold kernel stages rows up to this many bytes in shared memory
#: (no opt-in needed)
_SMEM_LIMIT = 48 * 1024
#: the fused kernel stages rows up to this many bytes (above 48 KB through
#: the opt-in attribute; an H100 block may use 227 KB)
_COMPRESS_SUM_SMEM_LIMIT = 160 * 1024
#: threads of a block: one row a block, and one histogram bin a thread
THREADS = 256
#: the longest run a thread holds in registers
MAX_REGISTER_RUN = 17
#: how a row reaches its block, as the C entries code it: "registers" (each
#: thread loads its run straight from global memory), "shared" (the row is
#: staged in shared memory and each thread reads its run there), "global"
#: (a row too long for shared memory, re-read from global memory each pass)
STAGES = {"global": 0, "registers": 1, "shared": 2}
#: the most blocks of a portable thread-block cluster: the client stacks
#: the fused kernel sums in one launch
MAX_CLUSTER = 8
#: the radix select's digits, most significant first, by the shift of
#: their lowest bit: bits 30-24 (7 bits), 23-16, 15-8 and 7-0
RADIX_SHIFTS = (24, 16, 8, 0)

_THRESHOLD_ARGS = ((ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
_COMPRESS_SUM_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7
                      + (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)))


@functools.lru_cache(maxsize=None)
def row_stage(T: int, smem_limit: int) -> tuple:
    """How a row of T float32 keys reaches its block: ``(stage, run)``,
    `run` the keys each thread owns, contiguous and odd (the lanes of a
    warp reading their runs in shared memory hit distinct banks).  Runs of
    up to `MAX_REGISTER_RUN` keys load into registers; a longer row is
    staged when its T·4 bytes fit in `smem_limit`, else read from global
    memory."""
    run = -(-T // THREADS) | 1
    if run <= MAX_REGISTER_RUN:
        return "registers", run
    return ("shared" if T * 4 <= smem_limit else "global"), run


def _clamp_k(k: int, T: int) -> int:
    # a threshold is undefined for an empty kept set; callers wanting k = 0
    # handle it before selection, as in the reference
    return max(1, min(int(k), T))


def _check(a32: torch.Tensor, what: str = "topk_row_threshold") -> None:
    if a32.dtype != torch.float32:
        raise TypeError(f"{what} searches float32 bit patterns, got {a32.dtype}")
    if a32.dim() != 2:
        raise ValueError(f"{what} takes (rows, T), got shape {tuple(a32.shape)}")
    if not a32.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")
    if a32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {a32.device}")


def topk_row_threshold_plain(a32: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's algorithm in PyTorch: (rows, T) f32 ≥ 0 → (rows, 1)."""
    _check(a32)
    rows, T = a32.shape
    kk = _clamp_k(k, T)
    keys = a32.view(torch.int32)
    t = torch.zeros((rows, 1), dtype=torch.int32, device=a32.device)
    for bit in range(30, -1, -1):
        cand = t | (1 << bit)
        cnt = (keys >= cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt >= kk, cand, t)
    return t.view(torch.float32)


def topk_row_threshold_radix_emulated(a32: torch.Tensor, k: int) -> tuple:
    """The kernels' radix select in PyTorch on int32 keys: per row the
    digits of `RADIX_SHIFTS`, a 256-bin histogram of the keys that match
    the prefix chosen so far, the bin where the count from the top reaches
    the k still wanted, and the narrowing.  Returns ``(threshold (rows, 1)
    f32, above (rows, 1) int64)``, `above` the keys strictly above the
    threshold as the passes count them.  A negative pattern (-0.0) counts
    as +0.0, as in the plain version."""
    _check(a32)
    rows, T = a32.shape
    kk = _clamp_k(k, T)
    keys = a32.view(torch.int32).clamp_min(0).long()
    prefix = torch.zeros((rows, 1), dtype=torch.long, device=a32.device)
    want = torch.full((rows, 1), kk, dtype=torch.long, device=a32.device)
    above = torch.zeros_like(want)
    known = 0
    for shift in RADIX_SHIFTS:
        match = (keys & known) == prefix
        digit = (keys >> shift) & 0xFF
        hist = torch.zeros((rows, 256), dtype=torch.long, device=a32.device)
        hist.scatter_add_(1, digit, match.long())
        from_bin = hist.flip(1).cumsum(1).flip(1)            # keys in bins b..255
        crossing = (from_bin >= want) & (from_bin - hist < want)
        d = crossing.long().argmax(dim=1, keepdim=True)
        gt = (from_bin - hist).gather(1, d)
        prefix = prefix | (d << shift)
        known |= 0xFF << shift
        above = above + gt
        want = want - gt
    return prefix.to(torch.int32).view(torch.float32), above


def _kernel(a32: torch.Tensor, kk: int) -> torch.Tensor:
    global launches
    fn = _build.bind("topk_threshold", "topk_row_threshold_f32", _THRESHOLD_ARGS)
    rows, T = a32.shape
    stage, run = row_stage(T, _SMEM_LIMIT)
    out = torch.empty((rows, 1), dtype=torch.float32, device=a32.device)
    stream = torch.cuda.current_stream(a32.device).cuda_stream
    err = fn(a32.data_ptr(), out.data_ptr(), rows, T, kk, STAGES[stage], run, stream)
    if err != 0:
        raise RuntimeError(f"topk_row_threshold kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def topk_row_threshold(a32: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row exact k-th largest of non-negative f32 `a32` (rows, T) →
    (rows, 1); k is clamped to [1, T].  Launches the CUDA kernel on a CUDA
    tensor; a CPU tensor takes `topk_row_threshold_plain`."""
    _check(a32)
    refuse_grad("topk_row_threshold", a32)
    if a32.device.type == "cpu":
        return topk_row_threshold_plain(a32, k)
    return _kernel(a32, _clamp_k(k, a32.shape[1]))


def keep_mask(a32: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly-k selection mask from a per-row threshold, along the last axis.

    Entries strictly above t are kept; the tie group at t is broken by
    earliest index (the one tie-break rule, as in the reference)."""
    above = a32 > t
    eq = a32 == t
    n_above = above.sum(dim=-1, keepdim=True)
    cum = eq.cumsum(dim=-1)
    return above | (eq & (cum <= k - n_above))


def _global_topk(x: torch.Tensor, k: int, threshold):
    if k <= 0:
        return (torch.zeros_like(x), torch.tensor(float("inf"), device=x.device),
                torch.tensor(0, device=x.device))
    flat = x.reshape(1, -1)
    kk = min(int(k), flat.shape[1])
    a32 = flat.abs().to(torch.float32)
    t = threshold(a32, kk)
    mask = keep_mask(a32, t, kk)
    dense = torch.where(mask, flat, torch.zeros((), dtype=x.dtype, device=x.device))
    return dense.reshape(x.shape), t[0, 0], mask.sum()


def topk_threshold(x: torch.Tensor, k: int):
    """Global exact Top-K over the whole of `x` (flattened): returns
    ``(dense, threshold, kept)`` — `x` with all but its k largest |·|
    zeroed, the k-th largest |x| as a float32 scalar, and the kept count,
    ``min(k, numel)`` exactly (the tie group at the threshold broken by
    earliest flat index), an int64 scalar.  k ≤ 0 keeps nothing: zeros,
    +inf and 0.  The threshold is kernel 1's (`topk_row_threshold`) on a
    CUDA tensor, its plain version on a CPU one."""
    return _global_topk(x, k, topk_row_threshold)


def topk_threshold_plain(x: torch.Tensor, k: int):
    """`topk_threshold` with the threshold's plain version on any device."""
    return _global_topk(x, k, topk_row_threshold_plain)


def topk_compress_sum_plain(v: torch.Tensor, k: int):
    """The fused kernel's function in PyTorch: per row of f32 `v` (n, T)
    keep the k largest |v| (`keep_mask` tie-break) → ``(dense (n, T),
    col_sum (T,))``, the column sum taken over rows in order 0..n−1."""
    _check(v, "topk_compress_sum")
    kk = _clamp_k(k, v.shape[1])
    a32 = v.abs()
    dense = torch.where(keep_mask(a32, topk_row_threshold_plain(a32, kk), kk), v, 0.0)
    col_sum = torch.zeros(v.shape[1], dtype=torch.float32, device=v.device)
    for row in dense:
        col_sum = col_sum + row
    return dense, col_sum


@dataclasses.dataclass(frozen=True)
class CompressSumPlan:
    """How the fused kernel runs one (n, T) stack (`compress_sum_plan`)."""
    n: int
    T: int
    #: one cluster launch of the n row blocks, the column sum through
    #: distributed shared memory; else a selection and a column-sum launch
    cluster: bool
    #: how a row reaches its block and the keys each thread owns
    #: (`row_stage`; a "registers" row is compressed into shared memory too)
    stage: str
    run: int
    #: columns each cluster block sums (0 off the cluster path)
    slice_cols: int

    @property
    def launches(self) -> int:
        """CUDA launches a call makes."""
        return 1 if self.cluster else 2

    def column_slices(self) -> list:
        """The [start, stop) columns each cluster block sums, by rank."""
        s = self.slice_cols
        return [(min(self.T, j * s), min(self.T, j * s + s)) for j in range(self.n)]


@functools.lru_cache(maxsize=None)
def compress_sum_plan(n: int, T: int) -> CompressSumPlan:
    """The fused kernel's form for an (n, T) float32 stack: one cluster
    launch exactly when n ≤ `MAX_CLUSTER` and a row's T·4 bytes fit in
    shared memory (`_COMPRESS_SUM_SMEM_LIMIT`), else two launches; rows
    reach their blocks as `row_stage` says."""
    stage, run = row_stage(T, _COMPRESS_SUM_SMEM_LIMIT)
    cluster = stage != "global" and 1 <= n <= MAX_CLUSTER
    return CompressSumPlan(n=n, T=T, cluster=cluster, stage=stage, run=run,
                           slice_cols=-(-T // n) if cluster else 0)


def _compress_sum_kernel(v: torch.Tensor, kk: int, plan: CompressSumPlan):
    global compress_sum_launches, compress_sum_cuda_launches
    fn = _build.bind("topk_compress_sum", "topk_compress_sum_f32", _COMPRESS_SUM_ARGS)
    n, T = v.shape
    if (plan.n, plan.T) != (n, T):
        raise ValueError(f"plan for {(plan.n, plan.T)} given a stack of {(n, T)}")
    dense = torch.empty_like(v)
    col_sum = torch.empty((T,), dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    made = ctypes.c_int(0)
    err = fn(v.data_ptr(), dense.data_ptr(), col_sum.data_ptr(), n, T, kk, int(plan.cluster),
             STAGES[plan.stage], plan.run, plan.slice_cols, stream, ctypes.byref(made))
    compress_sum_cuda_launches += made.value
    if err != 0:
        form = "cluster" if plan.cluster else "two-launch"
        raise RuntimeError(f"topk_compress_sum {form} launch ({plan}) failed: CUDA error {err}")
    compress_sum_launches += 1
    return dense, col_sum


def topk_compress_sum(v: torch.Tensor, k: int):
    """Exact |·|-Top-K of each row of f32 `v` (n, T) fused with the sum of
    the compressed rows: ``(dense (n, T), col_sum (T,))``.  ``dense`` is
    bitwise the two-pass selection (`topk_row_threshold` + `keep_mask`);
    ``col_sum`` sums the rows in order.  k is clamped to [1, T].  Launches
    the CUDA kernel on a CUDA tensor in `compress_sum_plan`'s form (a launch
    that fails raises; nothing falls back to the other form); a CPU tensor
    takes `topk_compress_sum_plain`."""
    _check(v, "topk_compress_sum")
    refuse_grad("topk_compress_sum", v)
    if v.device.type == "cpu":
        return topk_compress_sum_plain(v, k)
    n, T = v.shape
    return _compress_sum_kernel(v, _clamp_k(k, T), compress_sum_plan(n, T))
