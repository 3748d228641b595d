"""Wrappers over the tiled-matmul kernel — port of the GLM part of
`repro.kernels.ops` (``basis_project`` and ``glm_hessian``).

Both compute in float32 through `tiled_matmul.matmul`: the kernel on CUDA
tensors, its plain version on CPU tensors.  The engine's default route for
Γ = VᵀAV is a float64 einsum (`repro_torch.core.client_batch`); this one
is the opt-in float32 route.
"""
from __future__ import annotations

import torch

from .tiled_matmul import matmul


def basis_project(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Γ = Vᵀ (A V), the BL coefficient computation (Eq. 5), as two
    products with float32 accumulation.

    Takes a 2-D V (d, r) with a 2-D A (d, d) → (r, r); a batched V
    (n, d, r) with a batched A (n, d, d) → (n, r, r); or a shared 2-D V
    broadcast over a batched A.  Vᵀ is read through its strides."""
    T = matmul(A, V)                          # (…, d, r)
    return matmul(V.transpose(-1, -2), T)     # (…, r, r)


def glm_hessian(A: torch.Tensor, w: torch.Tensor, lam: float) -> torch.Tensor:
    """(1/m) Aᵀ diag(w) A + λI, the GLM Hessian (Eq. 3), for A (m, d)."""
    m, d = A.shape
    Aw = A * w[:, None].to(A.dtype)
    H = matmul(A.T, Aw) / m
    return H + lam * torch.eye(d, dtype=H.dtype, device=H.device)
