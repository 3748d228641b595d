"""Batched tiled matrix product with float32 accumulation: the CUDA kernel
and its plain version.

Port of `repro.kernels.tiled_matmul`.  `matmul(a, b)` computes ``C = A @ B``
for 2-D operands or with a leading batch axis on either or both (a 2-D
operand is broadcast over the other's batch), so one launch covers every
client of a stack.  Inputs may be float64, float32 or bfloat16; they are
converted to float32 as they are loaded and every sum accumulates in
float32, as the reference's kernel body does.  The result is float32, cast
to ``out_dtype`` at the end.

`matmul` launches the hand-written kernel (``csrc/tiled_matmul.cu``) on
CUDA tensors, reading each operand in place through its strides (a
transposed view or an expanded batch costs no copy), and takes the plain
PyTorch version, `matmul_plain`, only for tensors on the CPU.  The plain
version is ``a.float() @ b.float()``; on the card it is a full float32
product only with TF32 off, which `repro_torch.device.resolve` sets.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (the plain version on
#: CPU tensors does not count)
launches = 0

#: dtype codes of the kernel's C interface
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: the kernel's grid puts the batch on its z axis
_MAX_BATCH = 65535
_INT_MAX = 2 ** 31 - 1


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"matmul takes float32, float64 or bfloat16; {name} is {x.dtype}")
        if x.dim() not in (2, 3):
            raise ValueError(f"matmul takes 2-D or batched 3-D operands; {name} has "
                             f"shape {tuple(x.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dimensions differ: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"matmul operands lie on different devices {a.device}, {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul runs on cuda or cpu, got {a.device}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a.float() @ b.float()`` in PyTorch, cast to `out_dtype`."""
    _check(a, b)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def geometry(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The kernel's view of ``a @ b``: ``(batch, M, N, K, a_strides,
    b_strides)``, each operand's element strides as (batch, row, column),
    batch stride 0 for a 2-D operand broadcast over the other's batch."""
    batch = a.shape[0] if a.dim() == 3 else (b.shape[0] if b.dim() == 3 else 1)
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if batch > _MAX_BATCH or max(M, N, K) > _INT_MAX:
        raise ValueError(f"matmul kernel takes batch <= {_MAX_BATCH} and dimensions "
                         f"< 2**31; got a {tuple(a.shape)} @ b {tuple(b.shape)}")

    def strides(x):
        s = x.stride()
        return (s[0], s[1], s[2]) if x.dim() == 3 else (0, s[0], s[1])

    return batch, M, N, K, strides(a), strides(b)


def _kernel(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    batch, M, N, K, sa, sb = geometry(a, b)
    out = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    fn = _build.load("tiled_matmul").tiled_matmul
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), _DTYPES[a.dtype], *sa, b.data_ptr(), _DTYPES[b.dtype], *sb,
             out.data_ptr(), batch, M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul kernel launch failed: CUDA error {err}")
    launches += 1
    out = out if a.dim() == 3 or b.dim() == 3 else out[0]
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``C = A @ B`` with float32 accumulation: (M, K) or (n, M, K) times
    (K, N) or (n, K, N), a 2-D operand broadcast over the other's batch.
    Launches the CUDA kernel on CUDA tensors; CPU tensors take
    `matmul_plain`."""
    _check(a, b)
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype=out_dtype)
    return _kernel(a, b, out_dtype)
