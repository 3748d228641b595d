"""Matrix/vector compression operators (paper §3, §A.2) — the deterministic
subset of `repro.core.compressors`: `Identity`, `TopK` (BL1's and BL-DNN's
main paths) and `RankR` (FedNL's Hessian codec).

One natively-batched contract: ``compress(keys, x)`` takes a stack of n
inputs (leading client axis) and returns ``(compressed_dense, counts)`` —
zeros where entries were dropped, plus a `comm.Counts` record of what hit
the wire.  ``compress_sum`` adds the sum of the compressed stack over the
client axis (BL-DNN's Fisher leg).  ``keys`` is accepted and ignored by
`Identity`, `TopK` and `RankR`, which draw nothing; the stochastic compressors
(`rtopk` among them) come with the PRNG port (ROADMAP.md §1 items 9
and 10).

|·|-Top-K selection is one routine, `topk_keep_mask`: the threshold search
runs on a float32 copy through the exact threshold kernel
(`repro_torch.kernels.topk_threshold`), then the shared tie-break mask
keeps exactly k entries per row.  `TopK.compress_sum` on a CUDA float32
stack runs selection and client sum in the fused kernel
(`topk_compress_sum`), whose dense output is bitwise the two-pass one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.topk_threshold import keep_mask, topk_compress_sum, topk_row_threshold
from . import comm


def _numel(x: torch.Tensor) -> int:
    """Per-client element count of a client-stacked (n, ...) tensor."""
    n = 1
    for s in x.shape[1:]:
        n *= s
    return n


def _full(n: int, value, device) -> torch.Tensor:
    return torch.full((n,), float(value), dtype=torch.float64, device=device)


class Compressor:
    """Base class. Subclasses set `is_unbiased`, `delta` or `omega`."""

    is_unbiased: bool = False
    #: contraction parameter δ ∈ (0,1]  (contractive compressors)
    delta: Optional[float] = None
    #: variance parameter ω ≥ 0        (unbiased compressors)
    omega: Optional[float] = None
    #: True if C(A) is deterministic given A
    deterministic: bool = False

    @property
    def wire(self):
        """`comm.WireFormat` pricing this operator's `Counts`."""
        return comm.WireFormat()

    def compress(self, keys, x: torch.Tensor) -> Tuple[torch.Tensor, comm.Counts]:
        """Compress a client-stacked (n, ...) batch → ``(dense, counts)``
        with per-client (n,) counts; price them with
        ``comm.price(self.wire, counts)``."""
        raise NotImplementedError

    def compress_sum(self, keys, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, comm.Counts, torch.Tensor]:
        """Fused compress-then-reduce: `compress` plus the sum of the
        compressed stack over the client axis, ``(dense, counts,
        local_sum)``.  The default is the two-pass composition."""
        dense, counts = self.compress(keys, x)
        return dense, counts, dense.sum(dim=0)

    def __call__(self, key, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-client adapter: compress one tensor and price it.
        Returns (compressed_dense, bits_transmitted)."""
        dense, counts = self.compress(None if key is None else [key], x[None])
        return dense[0], comm.price(self.wire, counts)[0]


@dataclasses.dataclass(unsafe_hash=True)
class Identity(Compressor):
    """No compression; full tensor on the wire."""
    is_unbiased = True
    omega = 0.0
    delta = 1.0
    deterministic = True

    def compress(self, keys, x):
        return x, comm.Counts(floats=_full(x.shape[0], _numel(x), x.device))


def _selection_threshold(a32: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest per row of non-negative f32 `a32` (..., T) → (..., 1)."""
    t = topk_row_threshold(a32.reshape((-1,) + a32.shape[-1:]).contiguous(), k)
    return t.reshape(a32.shape[:-1] + (1,))


def topk_keep_mask(v: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the K largest-|v| entries along the last axis.

    Exactly K entries are kept per row: entries strictly above the f32
    threshold, then earliest-index entries inside the threshold tie group
    (sub-f32-ulp differences inside the group are broken by index)."""
    a32 = v.abs().to(torch.float32)
    return keep_mask(a32, _selection_threshold(a32, k), k)


@dataclasses.dataclass(unsafe_hash=True)
class TopK(Compressor):
    """Greedy sparsification (Eq. 21): keep K largest-|.| entries.

    Contractive with δ = K/numel.  Deterministic.  Only the flat selection
    is ported; ``symmetrize=True`` (the triangular-half codec of §A.2)
    raises until ROADMAP.md §1 item 10."""
    k: int
    symmetrize: bool = False

    def __post_init__(self):
        self.deterministic = True
        if self.symmetrize:
            raise NotImplementedError(
                "TopK(symmetrize=True) is not ported yet: ROADMAP.md §1 "
                "item 10 (the rest of the paper's figures) brings it")

    def compress(self, keys, x):
        n = x.shape[0]
        v = x.reshape(n, -1)
        kk = min(self.k, v.shape[1])
        out = torch.where(topk_keep_mask(v, kk), v, 0.0).reshape(x.shape)
        c = _full(n, kk, x.device)
        return out, comm.Counts(floats=c, indices=c)

    def compress_sum(self, keys, x):
        # a flat float32 stack runs the fused codec (the kernel on the card,
        # its plain version on the CPU); its dense output and counts equal
        # the two-pass default bitwise.  float64 streams take the default,
        # as in the reference.
        if x.dtype != torch.float32:
            return super().compress_sum(keys, x)
        n = x.shape[0]
        v = x.reshape(n, -1).contiguous()
        kk = min(self.k, v.shape[1])
        out, s = topk_compress_sum(v, kk)
        c = _full(n, kk, x.device)
        return (out.reshape(x.shape), comm.Counts(floats=c, indices=c),
                s.reshape(x.shape[1:]))


@dataclasses.dataclass(unsafe_hash=True)
class RankR(Compressor):
    """Low-rank approximation via SVD (Eq. 19–20): the best rank-R
    approximation of each matrix of an (n, p, q) stack.

    Contractive with δ = R/d on d×d matrices.  Deterministic.  The
    singular vectors are not unique, but their product is (when σ_R >
    σ_{R+1}), so the output is comparable across libraries."""
    r: int

    def __post_init__(self):
        self.deterministic = True

    def compress(self, keys, x):
        if x.dim() != 3:
            raise ValueError(f"Rank-R needs a stack of matrices, got shape {tuple(x.shape)}")
        n = x.shape[0]
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        rr = min(self.r, s.shape[-1])
        out = torch.matmul(u[:, :, :rr] * s[:, None, :rr], vt[:, :rr, :])
        # wire format: rr singular triples (u_i, σ_i, v_i)
        c = _full(n, rr * (x.shape[1] + x.shape[2] + 1), x.device)
        return out, comm.Counts(floats=c)


_PRNG_PENDING = ("draws from JAX's PRNG stream, which is not ported yet: "
                 "ROADMAP.md §1 item 9 (PRNG) brings it")


@dataclasses.dataclass(unsafe_hash=True)
class ComposedTopK(Compressor):
    """Top-K followed by a stochastic inner codec on the kept values."""
    k: int
    inner: object = None

    def __post_init__(self):
        raise NotImplementedError(f"ComposedTopK {_PRNG_PENDING}")


def rtopk(k: int) -> ComposedTopK:
    """RTop-K: Top-K composed with random dithering."""
    raise NotImplementedError(f"rtopk(k={k}) {_PRNG_PENDING}")
