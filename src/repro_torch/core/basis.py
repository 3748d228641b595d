"""Basis Learn: changes of basis in R^{d×d} (paper §2.3, §4) — the part of
`repro.core.basis` that BL1's main path runs.

A `MatrixBasis` provides the coefficient transform h(A) and the
reconstruction A = Σ_{jl} h_{jl} B^{jl}.  Ported bases:

  * ``standard``   — Example 4.1 (h(A) = A);
  * ``data_outer`` — §2.3: client data spans G_i = span{v_1..v_r}; the
                     coefficient matrix of A = Σ γ_tl v_t v_lᵀ is the r×r
                     Γ = VᵀAV, embedded top-left in a d×d zero array.

The other registered bases of the reference (``symmetric``, ``psd``,
``eigen``, ``dct`` and the pytree bases) raise `NotImplementedError` until
their ROADMAP.md items port them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .comm import FLOAT_BITS


class MatrixBasis:
    d: int
    #: number of (potentially) nonzero coefficients for a symmetric input
    n_coeff: int

    def h(self, A: torch.Tensor) -> torch.Tensor:
        """Coefficient matrix of a (d, d) A, as a (d, d) array with exact
        zeros where the basis stores nothing."""
        raise NotImplementedError

    def reconstruct(self, H: torch.Tensor) -> torch.Tensor:
        """Backward transform Σ_{jl} H_{jl} B^{jl}: (d, d) → (d, d)."""
        raise NotImplementedError


@dataclasses.dataclass
class StandardBasis(MatrixBasis):
    """Example 4.1: B^{jl} = e_j e_lᵀ.  h(A) = A.  BL1 ≡ FedNL here."""
    d: int

    def __post_init__(self):
        self.n_coeff = self.d * self.d

    def h(self, A):
        return A

    def reconstruct(self, H):
        return H


@dataclasses.dataclass
class DataOuterBasis(MatrixBasis):
    """§2.3 data-induced basis {v_t v_lᵀ}: V (d, r) has orthonormal columns
    spanning the client's data subspace, Γ = VᵀAV and A = VΓVᵀ exactly for
    A in the span (the ridge λI is added analytically by the server)."""
    V: torch.Tensor  # (d, r), orthonormal columns

    def __post_init__(self):
        self.d = int(self.V.shape[0])
        self.r = int(self.V.shape[1])
        self.n_coeff = self.r * self.r

    def h(self, A):
        out = torch.zeros((self.d, self.d), dtype=A.dtype, device=A.device)
        out[: self.r, : self.r] = self.V.T @ A @ self.V
        return out

    def reconstruct(self, H):
        return self.V @ H[: self.r, : self.r] @ self.V.T


def orth_basis_from_data(A_data: torch.Tensor, rcond: float = 1e-10) -> DataOuterBasis:
    """Orthonormal basis of the row space of the client's data (m, d), as
    the paper's use of scipy.linalg.orth (§6.1).

    LAPACK on the CPU and cuSOLVER on the card may return singular vectors
    of opposite sign.  A flipped v_t flips the sign of row and column t of
    every Γ and nothing else: Top-K selects on |Γ| and V Γ Vᵀ is unchanged,
    so the trajectory does not see it."""
    _, s, vt = torch.linalg.svd(A_data, full_matrices=False)
    tol = s.max() * max(A_data.shape) * rcond
    r = max(int((s > tol).sum()), 1)
    return DataOuterBasis(V=vt[:r].T)


def basis_transmission_bits(basis: MatrixBasis, float_bits: int = FLOAT_BITS) -> float:
    """One-time cost of shipping the basis (Table 1: rd floats for the data
    basis); convention bases cost nothing."""
    if isinstance(basis, DataOuterBasis):
        return float(basis.d * basis.r * float_bits)
    return 0.0


#: the reference's registered basis names and the ROADMAP.md item that
#: ports each one still missing here
_PENDING = {"symmetric": 10, "psd": 10, "eigen": 10, "dct": 10,
            "per_layer_svd": 12, "dct_tree": 12, "hadamard_tree": 12}


def available_bases() -> List[str]:
    return ["data_outer", "standard"]


def make_bases(name: str, clients: Sequence, x0: Optional[torch.Tensor] = None,
               **kw) -> List[MatrixBasis]:
    """One `MatrixBasis` per client for a registered basis name; the bases
    live on the device of the clients' data."""
    clients = list(clients)
    if name == "standard":
        d = int(clients[0].A.shape[1])
        return [StandardBasis(d) for _ in clients]
    if name == "data_outer":
        rcond = kw.pop("rcond", 1e-10)
        if kw:
            raise TypeError(f"unexpected data_outer options {sorted(kw)}")
        return [orth_basis_from_data(c.A, rcond=rcond) for c in clients]
    if name in _PENDING:
        raise NotImplementedError(
            f"basis {name!r} is not ported yet: ROADMAP.md §1 item "
            f"{_PENDING[name]} brings it")
    raise KeyError(f"unknown basis {name!r}; registered: {available_bases()}")
