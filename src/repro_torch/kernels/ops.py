"""Wrappers over the port's kernels — port of `repro.kernels.ops`.

Each wrapper launches its kernel on CUDA tensors and takes the kernel's
plain version on CPU tensors.  ``matmul`` is `tiled_matmul.matmul` (kernel
3); ``basis_project`` and ``glm_hessian`` compute in float32 through it.
``basis_transform`` is kernel 4 (A·gᵢ·B over a client stack) and
``topk_compress`` the global exact Top-K of `topk_threshold.topk_threshold`
(kernel 1).  The engine's default route for Γ = VᵀAV is a float64 einsum
(`repro_torch.core.client_batch`); this one is the opt-in float32 route.
``attention`` and ``ssd`` are the LM stack's: kernel 5
(`flash_attention`) and kernel 6 (`ssd_scan`), in the model's layout.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import basis_transform as _bt
from . import tiled_matmul as _tm
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan, ssd_scan_plain
from .topk_threshold import topk_threshold


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``a @ b`` with float32 accumulation, cast to `out_dtype` (kernel 3;
    2-D or batched operands, see `tiled_matmul.matmul`)."""
    return _tm.matmul(a, b, out_dtype=out_dtype)


def basis_project(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Γ = Vᵀ (A V), the BL coefficient computation (Eq. 5), as two
    products with float32 accumulation.

    Takes a 2-D V (d, r) with a 2-D A (d, d) → (r, r); a batched V
    (n, d, r) with a batched A (n, d, d) → (n, r, r); or a shared 2-D V
    broadcast over a batched A.  Vᵀ is read through its strides."""
    T = matmul(A, V)                          # (…, d, r)
    return matmul(V.transpose(-1, -2), T)     # (…, r, r)


def basis_transform(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A · gᵢ · B for every client i of a stacked (n, d1, d2) float32 leaf —
    the pytree-basis rotation Uᵀ g V / U c Vᵀ (kernel 4)."""
    return _bt.basis_transform(A, g, B)


def topk_compress(x: torch.Tensor, k: int) -> tuple:
    """Exact global Top-K of `x`: ``(dense, kept)``, kept == min(k, numel)
    with ties broken by earliest index (`topk_threshold.topk_threshold`,
    whose threshold is kernel 1's)."""
    dense, _, kept = topk_threshold(x, k)
    return dense, kept


def glm_hessian(A: torch.Tensor, w: torch.Tensor, lam: float) -> torch.Tensor:
    """(1/m) Aᵀ diag(w) A + λI, the GLM Hessian (Eq. 3), for A (m, d)."""
    m, d = A.shape
    Aw = A * w[:, None].to(A.dtype)
    H = matmul(A.T, Aw) / m
    return H + lam * torch.eye(d, dtype=H.dtype, device=H.device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, q_pos0: int = 0) -> torch.Tensor:
    """Masked softmax attention over (B, S, H, hd) with grouped KV heads
    (B, S, KVH, hd): kernel 5 reads KV head ``h // (H // KVH)`` in place, so
    the reference's head transpose and KV repeat are not materialised.  The
    queries stand at positions ``q_pos0 ..`` (a sequence-parallel slice)."""
    return flash_attention(q, k, v, causal=causal, window=window, q_pos0=q_pos0)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 256) -> tuple:
    """Mamba2 SSD in the model's layout — x (B, S, H, hd), dt (B, S, H),
    A (H,), B and C (B, S, N) shared by the heads — through kernel 6:
    returns (y, final state (B, H, hd, N)).  The reference's `ops.ssd` takes
    the heads-folded (B·H, S, ·) layout and returns y alone.  `chunk` sets
    only the plain version's chunks on CPU tensors (see `ssd_scan`).
    Float64 CPU operands (a float64 run of the model: the sharded path's
    rounding witness in the CPU tests) take the plain version in float64;
    the wrapper refuses float64 elsewhere."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
