"""Basis Learn: changes of basis in R^{d×d} and S^d (paper §2.3, §4, §5)
and on parameter pytrees (BL-DNN) — port of `repro.core.basis`.

A `MatrixBasis` provides the coefficient transform h(A) and the
reconstruction A = Σ_{jl} h_{jl} B^{jl}.  Registered bases
(`make_bases`):

  * ``standard``      — Example 4.1 (h(A) = A);
  * ``symmetric``     — Example 4.2 on S^d: h(A) is A's lower triangle;
  * ``psd``           — Example 5.1: B^{jl} ⪰ 0 (BL3's basis);
  * ``data_outer``    — §2.3: client data spans G_i = span{v_1..v_r}; the
                        coefficient matrix of A = Σ γ_tl v_t v_lᵀ is the
                        r×r Γ = VᵀAV, embedded top-left in a d×d zero array;
  * ``eigen``         — B^{jl} = q_j q_lᵀ for the eigenvectors Q of the
                        fleet's averaged Hessian at x⁰, shipped once (d²
                        floats on the ``basis_ship`` leg);
  * ``dct``           — the same rotation with the orthonormal DCT-II
                        factor, a convention both sides build (free);
  * ``per_layer_svd`` — the pytree basis of BL-DNN: every 2-D weight leaf
                        gets the complete SVD factors (U, V) of its
                        initialization; gradients travel as Uᵀ g V;
  * ``dct_tree``, ``hadamard_tree`` — the same rotations with per-leaf
                        DCT-II / Walsh–Hadamard factors built from the leaf
                        shapes (nothing shipped).

A client-stacked float32 leaf on the card is rotated by the hand-written
`repro_torch.kernels.basis_transform` kernel; the float64 GLM rotations of
``eigen`` and ``dct`` are einsums, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.basis_transform import basis_transform
from . import comm
from .comm import FLOAT_BITS
from .compressors import topk_keep_mask
from .pytree import tree_leaves, tree_unflatten


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


@dataclasses.dataclass
class SymmetricBasis(MatrixBasis):
    """Example 4.2 on symmetric A: h(A) is the lower triangle; B^{jl}
    (j > l) has ones at (j, l) and (l, j), B^{jj} one at (j, j)."""
    d: int

    def __post_init__(self):
        self.n_coeff = self.d * (self.d + 1) // 2

    def h(self, A):
        return torch.tril(A)

    def reconstruct(self, H):
        return torch.tril(H) + torch.tril(H, -1).T


@dataclasses.dataclass
class PSDBasis(MatrixBasis):
    """Example 5.1: for j ≠ l, B^{jl} has ones at (j,l), (l,j), (j,j) and
    (l,l), so every B^{jl} ⪰ 0.  For symmetric A: c_{jl} = A_{jl} (j > l)
    and c_{jj} = A_{jj} − Σ_{l≠j} A_{jl}."""
    d: int

    def __post_init__(self):
        self.n_coeff = self.d * (self.d + 1) // 2

    def h(self, A):
        diag = torch.diagonal(A)
        return torch.tril(A, -1) + torch.diag(diag - (A.sum(dim=1) - diag))

    def reconstruct(self, H):
        off = torch.tril(H, -1)
        sym_off = off + off.T
        return sym_off + torch.diag(torch.diagonal(H) + sym_off.sum(dim=1))


@dataclasses.dataclass
class RotationBasis(MatrixBasis):
    """B^{jl} = q_j q_lᵀ for one orthogonal Q (d, d): h(A) = QᵀAQ and
    A = Q h Qᵀ for every matrix (no data span, no analytic ridge)."""
    Q: torch.Tensor

    def __post_init__(self):
        self.d = int(self.Q.shape[0])
        self.n_coeff = self.d * self.d

    def h(self, A):
        return self.Q.T @ A @ self.Q

    def reconstruct(self, H):
        return self.Q @ H @ self.Q.T


@dataclasses.dataclass
class EigenBasis(RotationBasis):
    """The eigenvectors of the fleet's averaged initial Hessian: data
    dependent, so Q ships once (d² floats, `basis_transmission_bits`)."""

    def shipped(self, ship: comm.BasisShipSpec) -> Tuple["EigenBasis", float]:
        """The basis as it arrives after a compressed shipment — Q through
        `quantize_ship_factor` — and the shipment's exact bits; the
        receiver rotates with the quantized Q."""
        Q, bits = quantize_ship_factor(self.Q, ship)
        return EigenBasis(Q=Q), bits


class DCTBasis(RotationBasis):
    """The orthonormal DCT-II rotation (float64): a convention both sides
    build, so nothing ships."""

    def __init__(self, d: int, device=None):
        super().__init__(Q=_dct_matrix(d, device, dtype=torch.float64))


def eigen_basis_from_clients(clients, x0: Optional[torch.Tensor] = None
                             ) -> List[EigenBasis]:
    """One `EigenBasis` shared by every client: the eigenvectors of the
    fleet's averaged Hessian ∇²f(x⁰) (x⁰ = 0 by default).  The list holds
    the same object n times; `client_batch.stack_bases` requires one Q."""
    from . import glm

    clients = list(clients)
    d = int(clients[0].A.shape[1])
    if x0 is None:
        x0 = torch.zeros(d, dtype=clients[0].A.dtype, device=clients[0].A.device)
    H0 = glm.global_hess(clients, x0)
    _, Q = torch.linalg.eigh((H0 + H0.T) / 2.0)
    basis = EigenBasis(Q=Q)
    return [basis for _ in clients]


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
    basis, d² for the eigenbasis); convention bases cost nothing."""
    if isinstance(basis, DataOuterBasis):
        return float(basis.d * basis.r * float_bits)
    if isinstance(basis, EigenBasis):
        return float(basis.d * basis.d * float_bits)
    return 0.0


# --------------------------------------------------------------------------
# compressed basis shipment
# --------------------------------------------------------------------------
def quantize_ship_factor(M: torch.Tensor, ship: comm.BasisShipSpec
                         ) -> Tuple[torch.Tensor, float]:
    """One shipped (rows, cols) basis factor after the wire: the values the
    receiver rotates with and the exact bits they cost.

      * ``col_frac < 1`` keeps each column's top ``ceil(col_frac·rows)``
        magnitudes (`compressors.topk_keep_mask`);
      * ``float_bits = 16`` is a bfloat16 round-trip, ``8`` symmetric
        per-column int8 (scale = max|col|/127), ``32``/``64`` plain casts.

    Returns the factor in its own dtype and the bits as a python float."""
    if M.dim() != 2:
        raise ValueError(f"shipped basis factors are 2-D, got {tuple(M.shape)}")
    rows, cols = int(M.shape[0]), int(M.shape[1])
    W = M if ship.float_bits == 64 else M.to(torch.float32)
    if not ship.dense:
        k = max(1, min(rows, int(math.ceil(ship.col_frac * rows))))
        keep = topk_keep_mask(W.T.contiguous(), k).T
        W = torch.where(keep, W, torch.zeros_like(W))
    if ship.float_bits == 16:
        W = W.to(torch.bfloat16).to(torch.float32)
    elif ship.float_bits == 8:
        scale = W.abs().amax(dim=0, keepdim=True) / 127.0
        scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
        W = torch.clamp(torch.round(W / scale), -127.0, 127.0) * scale
    bits = float(comm.price(ship.wire, ship.factor_counts(rows, cols)))
    return W.to(M.dtype), bits


def _two_sided(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """One rotated leaf, ``(A @ g) @ B``.  A client-stacked float32 leaf on
    the card goes through the `basis_transform` kernel, which reads a
    transposed factor (``U.mT``) in place; anything else (the CPU, the 2-D
    fleet mean) is the plain product."""
    if (g.dim() == 3 and g.is_cuda and g.dtype == torch.float32
            and A.dtype == torch.float32 and B.dtype == torch.float32):
        if not (A.is_contiguous() or A.mT.is_contiguous()):
            A = A.contiguous()
        return basis_transform(A, g.contiguous(), B.contiguous())
    return A @ g @ B


@dataclasses.dataclass
class PerLayerSVDBasis:
    """Pytree basis for DNN parameter trees: every 2-D weight leaf gets a
    complete orthogonal basis (U_ℓ, V_ℓ) from the SVD of its
    initialization, and its gradient travels as U_ℓᵀ g V_ℓ.  Other leaves
    pass through.  ``UV`` follows `tree_leaves` order: ``(U, V)`` for
    rotated leaves, ``None`` for pass-through ones.  Leaves may carry a
    leading client axis."""

    UV: tuple

    def _map(self, fn, tree):
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.UV):
            raise ValueError(
                f"tree has {len(leaves)} leaves but basis covers "
                f"{len(self.UV)} — built from a different parameter tree?")
        return tree_unflatten(tree, [leaf if uv is None else fn(uv[0], uv[1], leaf)
                                     for uv, leaf in zip(self.UV, leaves)])

    def rotate(self, tree):
        """Leaf-wise forward transform U_ℓᵀ g V_ℓ."""
        return self._map(lambda U, V, g: _two_sided(U.mT, g.to(U.dtype), V), tree)

    def unrotate(self, tree):
        """Exact inverse of `rotate`: U_ℓ c V_ℓᵀ per rotated leaf."""
        return self._map(lambda U, V, c: _two_sided(U, c, V.mT), tree)

    def ship_floats(self) -> float:
        """One shipment's size in floats, Σ_ℓ |U_ℓ| + |V_ℓ|."""
        return float(sum(uv[0].numel() + uv[1].numel()
                         for uv in self.UV if uv is not None))

    def shipped(self, ship: comm.BasisShipSpec) -> Tuple["PerLayerSVDBasis", float]:
        """The basis as it arrives after a compressed shipment (every factor
        through `quantize_ship_factor`) and the shipment's exact bits."""
        new_uv, bits = [], 0.0
        for uv in self.UV:
            if uv is None:
                new_uv.append(None)
                continue
            U, bu = quantize_ship_factor(uv[0], ship)
            V, bv = quantize_ship_factor(uv[1], ship)
            new_uv.append((U, V))
            bits += bu + bv
        return type(self)(UV=tuple(new_uv)), bits

    def to(self, device) -> "PerLayerSVDBasis":
        return type(self)(UV=tuple(None if uv is None else (uv[0].to(device), uv[1].to(device))
                                   for uv in self.UV))


def per_layer_svd_basis(params, use_basis: bool = True,
                        min_dim: int = 2) -> PerLayerSVDBasis:
    """The `PerLayerSVDBasis` of a parameter pytree's initialization:
    every 2-D leaf with both dims ≥ `min_dim` gets (U, V) from its full SVD
    (``full_matrices=True``: a truncated V would project out every gradient
    component outside the weight's row space).

    The factors of a rank-deficient weight are not unique, and LAPACK and
    cuSOLVER pick different ones, so the SVD is always LAPACK's ``sgesdd``
    through scipy on the host — the routine jax's CPU SVD calls, so on one
    machine the factors of equal weights are the reference's bit for bit —
    and the factors go to the leaves' device (set-up work on leaves of a
    few hundred rows).  Runs that must match a reference computed elsewhere
    carry its factors across (`repro_torch.core.convert`)."""
    import scipy.linalg

    out = []
    for p in tree_leaves(params):
        if use_basis and p.dim() == 2 and min(p.shape) >= min_dim:
            u, _, vt = scipy.linalg.svd(p.detach().to("cpu", torch.float32).numpy(),
                                        full_matrices=True, lapack_driver="gesdd")
            out.append((torch.from_numpy(u).to(p.device), torch.from_numpy(vt).to(p.device).mT))
        else:
            out.append(None)
    return PerLayerSVDBasis(UV=tuple(out))


class StructuredTreeBasis(PerLayerSVDBasis):
    """Pytree basis whose per-leaf rotations are conventions (DCT-II or
    Walsh–Hadamard): both sides build the factors from the leaf shapes, so
    nothing travels — ``ship_floats() == 0`` and `shipped` is the identity
    at zero bits."""

    def ship_floats(self) -> float:
        return 0.0

    def shipped(self, ship: comm.BasisShipSpec) -> Tuple["StructuredTreeBasis", float]:
        return self, 0.0


def _dct_matrix(d: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Orthonormal DCT-II factor (columns = basis vectors) in ``dtype``;
    in float64 it is `repro.core.basis.DCTBasis`'s Q bit for bit."""
    j = np.arange(d)[:, None]
    t = np.arange(d)[None, :]
    C = np.sqrt(2.0 / d) * np.cos(np.pi * (t + 0.5) * j / d)
    C[0] *= np.sqrt(0.5)
    return torch.tensor(C.T, dtype=dtype, device=device)


def _hadamard_matrix(d: int, device=None) -> torch.Tensor:
    """Normalized Walsh–Hadamard factor H_d/√d for power-of-two d; the
    identity otherwise (that side of the leaf passes through)."""
    if d & (d - 1):
        return torch.eye(d, dtype=torch.float32, device=device)
    H = np.array([[1.0]])
    while H.shape[0] < d:
        H = np.block([[H, H], [H, -H]])
    return torch.tensor(H / np.sqrt(d), dtype=torch.float32, device=device)


def structured_tree_basis(params, kind: str = "dct",
                          min_dim: int = 2) -> StructuredTreeBasis:
    """The free structured basis of a parameter pytree: every 2-D leaf
    with both dims ≥ `min_dim` gets fixed orthogonal (U, V) from its shape
    (``kind`` ∈ {"dct", "hadamard"}), on the leaf's device."""
    factories = {"dct": _dct_matrix, "hadamard": _hadamard_matrix}
    if kind not in factories:
        raise KeyError(f"unknown structured-basis kind {kind!r}; one of {sorted(factories)}")
    make = factories[kind]
    out = []
    for p in tree_leaves(params):
        if p.dim() == 2 and min(p.shape) >= min_dim:
            out.append((make(int(p.shape[0]), p.device), make(int(p.shape[1]), p.device)))
        else:
            out.append(None)
    return StructuredTreeBasis(UV=tuple(out))


#: the registered d×d bases that are conventions of their width, by name
CONVENTION_BASES = {"standard": StandardBasis, "symmetric": SymmetricBasis,
                    "psd": PSDBasis}

# --------------------------------------------------------------------------
# registry: "which basis" as a configuration axis
# --------------------------------------------------------------------------
BasisFactory = Callable[..., object]
#: basis factories by name (`register_basis`)
BASIS_REGISTRY: Dict[str, BasisFactory] = {}
#: registered names whose basis transforms parameter pytrees (BL-DNN), not
#: d×d matrices: their factory takes the parameter tree where a matrix
#: basis takes the client fleet
PYTREE_BASES: set = set()


def register_basis(name: str, *, pytree: bool = False):
    """Register a fleet-level basis factory ``factory(clients, x0=None,
    **kw) -> [MatrixBasis, ...]`` under `name`; ``pytree=True`` marks a
    pytree-basis factory ``factory(params, x0=None, **kw)`` that returns
    the fleet-global basis object."""
    def deco(factory: BasisFactory) -> BasisFactory:
        BASIS_REGISTRY[name] = factory
        if pytree:
            PYTREE_BASES.add(name)
        return factory
    return deco


def available_bases() -> List[str]:
    return sorted(BASIS_REGISTRY)


def is_pytree_basis(name: str) -> bool:
    """True for registered bases that transform parameter pytrees."""
    return name in PYTREE_BASES


def make_bases(name: str, clients: Sequence, x0: Optional[torch.Tensor] = None,
               **kw):
    """One `MatrixBasis` per client for a registered d×d basis name, on the
    device of the clients' data (``kw``: the factory's options, e.g.
    ``rcond`` for ``data_outer``).  For a pytree basis (`is_pytree_basis`)
    `clients` is the parameter tree and the result is the fleet-global
    basis object itself."""
    if name not in BASIS_REGISTRY:
        raise KeyError(f"unknown basis {name!r}; registered: {available_bases()}")
    if name in PYTREE_BASES:
        return BASIS_REGISTRY[name](clients, x0=x0, **kw)
    return BASIS_REGISTRY[name](list(clients), x0=x0, **kw)


def _fleet_d(clients) -> int:
    return int(clients[0].A.shape[1])


def _register_convention(name: str, cls) -> None:
    register_basis(name)(lambda clients, x0=None: [cls(_fleet_d(clients)) for _ in clients])


for _name, _cls in CONVENTION_BASES.items():
    _register_convention(_name, _cls)


@register_basis("data_outer")
def _data_outer_bases(clients, x0=None, rcond: float = 1e-10):
    return [orth_basis_from_data(c.A, rcond=rcond) for c in clients]


@register_basis("eigen")
def _eigen_bases(clients, x0=None):
    return eigen_basis_from_clients(clients, x0=x0)


@register_basis("dct")
def _dct_bases(clients, x0=None):
    basis = DCTBasis(_fleet_d(clients), device=clients[0].A.device)
    return [basis for _ in clients]


@register_basis("per_layer_svd", pytree=True)
def _per_layer_svd_bases(params, x0=None, use_basis: bool = True):
    return per_layer_svd_basis(params, use_basis=use_basis)


@register_basis("dct_tree", pytree=True)
def _dct_tree_bases(params, x0=None, min_dim: int = 2):
    return structured_tree_basis(params, kind="dct", min_dim=min_dim)


@register_basis("hadamard_tree", pytree=True)
def _hadamard_tree_bases(params, x0=None, min_dim: int = 2):
    return structured_tree_basis(params, kind="hadamard", min_dim=min_dim)
