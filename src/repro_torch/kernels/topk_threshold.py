"""Exact |·|-Top-K threshold selection: the CUDA kernel and its plain version.

Port of `repro.kernels.topk_threshold` (``topk_row_threshold`` and
``keep_mask``).  Per row of non-negative float32 values the threshold is
the EXACT k-th largest, found by a 31-pass binary search over the int32 bit
patterns (monotone in value for non-negative floats), so it equals
``torch.topk(a, k).values[..., -1:]`` bit for bit and the shared tie-break
`keep_mask` keeps exactly k entries per row.

`topk_row_threshold` launches the hand-written kernel
(``csrc/topk_threshold.cu``) on a CUDA tensor and takes the plain PyTorch
version, `topk_row_threshold_plain`, only for a tensor on the CPU.
`keep_mask` runs outside the kernel in the reference too, so it stays
plain PyTorch here.

`topk_compress_sum` is the fused codec of the reference's Fisher leg: the
same selection applied to every row of a signed (n, T) client stack, the
dense kept values, and their sum over the client axis in row order
(``csrc/topk_compress_sum.cu``; plain version `topk_compress_sum_plain`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the threshold kernel since the last reset (the plain version
#: on a CPU tensor does not count)
launches = 0
#: launches of the fused compress-sum kernel, counted the same way
compress_sum_launches = 0

#: rows up to this many bytes are staged in shared memory (no opt-in needed)
_SMEM_LIMIT = 48 * 1024
#: the fused kernel stages rows up to this many bytes (above 48 KB through
#: the opt-in attribute; an H100 block may use 227 KB)
_COMPRESS_SUM_SMEM_LIMIT = 160 * 1024


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
    """The kernel's algorithm in PyTorch: (rows, T) f32 ≥ 0 → (rows, 1)."""
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


def _kernel(a32: torch.Tensor, kk: int) -> torch.Tensor:
    global launches
    lib = _build.load("topk_threshold")
    fn = lib.topk_row_threshold_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows, T = a32.shape
    out = torch.empty((rows, 1), dtype=torch.float32, device=a32.device)
    stream = torch.cuda.current_stream(a32.device).cuda_stream
    err = fn(a32.data_ptr(), out.data_ptr(), rows, T, kk, _SMEM_LIMIT, stream)
    if err != 0:
        raise RuntimeError(f"topk_row_threshold kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def topk_row_threshold(a32: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row exact k-th largest of non-negative f32 `a32` (rows, T) →
    (rows, 1); k is clamped to [1, T].  Launches the CUDA kernel on a CUDA
    tensor; a CPU tensor takes `topk_row_threshold_plain`."""
    _check(a32)
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


def _compress_sum_kernel(v: torch.Tensor, kk: int):
    global compress_sum_launches
    lib = _build.load("topk_compress_sum")
    fn = lib.topk_compress_sum_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, T = v.shape
    dense = torch.empty_like(v)
    col_sum = torch.empty((T,), dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = fn(v.data_ptr(), dense.data_ptr(), col_sum.data_ptr(), n, T, kk,
             _COMPRESS_SUM_SMEM_LIMIT, stream)
    if err != 0:
        raise RuntimeError(f"topk_compress_sum kernel launch failed: CUDA error {err}")
    compress_sum_launches += 1
    return dense, col_sum


def topk_compress_sum(v: torch.Tensor, k: int):
    """Exact |·|-Top-K of each row of f32 `v` (n, T) fused with the sum of
    the compressed rows: ``(dense (n, T), col_sum (T,))``.  ``dense`` is
    bitwise the two-pass selection (`topk_row_threshold` + `keep_mask`);
    ``col_sum`` sums the rows in order.  k is clamped to [1, T].  Launches
    the CUDA kernel on a CUDA tensor; a CPU tensor takes
    `topk_compress_sum_plain`."""
    _check(v, "topk_compress_sum")
    if v.device.type == "cpu":
        return topk_compress_sum_plain(v, k)
    return _compress_sum_kernel(v, _clamp_k(k, v.shape[1]))
