"""Two-sided basis transform (A·gᵢ)·B over a client stack: the CUDA kernel
and its plain version.

Port of `repro.kernels.basis_transform`.  The pytree bases of BL-DNN
(`repro_torch.core.basis.PerLayerSVDBasis` and the structured DCT /
Hadamard kinds) rotate every client's gradient leaf each round:
``Uᵀ · g · V`` for an (n, d1, d2) stack.  `basis_transform` launches the
hand-written kernel (``csrc/basis_transform.cu``) on CUDA tensors and takes
the plain PyTorch version, `basis_transform_plain`, only for tensors on
the CPU.  Both associate as (A·gᵢ)·B, in float32 with TF32 off.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (the plain version on
#: CPU tensors does not count)
launches = 0

#: the most dynamic shared memory one block may use on an H100
_SMEM_MAX = 227 * 1024


def _check(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> None:
    if g.dim() != 3:
        raise ValueError(
            f"basis_transform takes a client-stacked (n, d1, d2) leaf, got "
            f"shape {tuple(g.shape)}")
    for name, x in (("A", A), ("g", g), ("B", B)):
        if x.dtype != torch.float32:
            raise TypeError(f"basis_transform is float32-only, {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"basis_transform needs contiguous tensors, {name} is not")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != g.shape[1] \
            or B.shape[0] != g.shape[2]:
        raise ValueError(
            f"factor/leaf shape mismatch: A {tuple(A.shape)} · g {tuple(g.shape)} "
            f"· B {tuple(B.shape)}")
    devices = {A.device, g.device, B.device}
    if len(devices) != 1:
        raise ValueError(f"basis_transform operands lie on different devices {devices}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"basis_transform runs on cuda or cpu, got {g.device}")


def basis_transform_plain(A: torch.Tensor, g: torch.Tensor,
                          B: torch.Tensor) -> torch.Tensor:
    """``(A @ g[i]) @ B`` for every client i in PyTorch: (da, d1) ×
    (n, d1, d2) × (d2, db) → (n, da, db)."""
    _check(A, g, B)
    return torch.matmul(torch.matmul(A, g), B)


def _kernel(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _build.load("basis_transform")
    n, d1, d2 = g.shape
    da, db = A.shape[0], B.shape[1]
    smem_fn = lib.basis_transform_smem_bytes
    smem_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    smem_fn.restype = ctypes.c_longlong
    smem = smem_fn(d1, d2)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"basis_transform keeps a block's rows of A and of A·gᵢ in shared "
            f"memory: d1={d1}, d2={d2} need {smem} bytes, more than the "
            f"{_SMEM_MAX} an H100 block may use")
    fn = lib.basis_transform_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, da, db), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(A.data_ptr(), g.data_ptr(), B.data_ptr(), out.data_ptr(),
             n, da, d1, d2, db, stream)
    if err != 0:
        raise RuntimeError(f"basis_transform kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def basis_transform(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(A @ g[i]) @ B`` for every client i: (da, d1) × (n, d1, d2) ×
    (d2, db) → (n, da, db), float32.  Launches the CUDA kernel on CUDA
    tensors (raising `ValueError` for a shape whose rows do not fit a
    block's shared memory); CPU tensors take `basis_transform_plain`."""
    _check(A, g, B)
    if g.device.type == "cpu":
        return basis_transform_plain(A, g, B)
    return _kernel(A, g, B)
