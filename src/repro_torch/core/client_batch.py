"""Stacked per-client state for the batched BL engine — port of
`repro.core.client_batch`.

  * `ClientBatch`  — data ``A (n, m, d)``, labels ``b (n, m)``, shared λ;
  * `BatchedBasis` — one basis kind for the whole fleet: ``standard``,
    ``symmetric``, ``psd``, ``data_outer`` (per-client matrices
    zero-padded to a common ``r_max``, ``V (n, d, r_max)``; padded columns
    are exactly zero), or a rotation, ``eigen`` or ``dct`` (one Q for the
    fleet, stacked ``Q (n, d, d)``);
  * `TreeBatch`    — the BL-DNN fleet: any pytree (nested dict) of data
    leaves stacked on a leading client axis;
  * `ClientStore`  — a fleet kept on the host in numpy for the
    cohort-streaming engine (`repro_torch.core.cohort`), and
    `synthetic_store`, its synthetic logistic-regression fleet.

The batched GLM math mirrors `glm` one-to-one, vectorized over the client
axis, in the reference's formulas and association order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import glm
from .pytree import tree_leaves
from .basis import CONVENTION_BASES, DCTBasis, DataOuterBasis, EigenBasis, MatrixBasis
from .comm import FLOAT_BITS

#: routes of the data basis's projection Γ = VᵀAV: "einsum" is the float64
#: default; "kernel" is the float32 route through the tiled-matmul kernel
#: (the reference's ``REPRO_BL_PALLAS=1`` route), stored back into the
#: float64 coefficient array
PROJECT_ROUTES = ("einsum", "kernel")


@dataclasses.dataclass
class ClientBatch:
    """All clients' GLM data stacked on a leading client axis."""

    A: torch.Tensor  # (n, m, d)
    b: torch.Tensor  # (n, m)
    lam: float       # shared ridge coefficient

    def __post_init__(self):
        if self.A.dim() != 3:
            raise ValueError(
                "ClientBatch.A must be client-stacked (n, m, d); got shape "
                f"{tuple(self.A.shape)}")
        if tuple(self.b.shape) != tuple(self.A.shape[:2]):
            raise ValueError(
                "ClientBatch.b must have shape (n, m) = A.shape[:2] = "
                f"{tuple(self.A.shape[:2])}; got {tuple(self.b.shape)}")

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[1]

    @property
    def d(self) -> int:
        return self.A.shape[2]


#: the rotation kinds: B^{jl} = q_j q_lᵀ for one orthogonal Q
ROTATION_KINDS = ("eigen", "dct")


@dataclasses.dataclass
class BatchedBasis:
    """A fleet-wide basis: one kind, with per-client ranks ``rs`` kept for
    the bit accounting (the wire cost depends on r_i, not r_max; d for
    every kind but ``data_outer``) and the route of the data basis's
    Γ = VᵀAV (``project``, one of `PROJECT_ROUTES`; it changes no bit
    count)."""

    kind: str
    d: int
    rs: Tuple[int, ...]
    V: Optional[torch.Tensor] = None  # (n, d, r_max) for kind == "data_outer"
    project: str = "einsum"
    Q: Optional[torch.Tensor] = None  # (n, d, d) for the rotation kinds

    @property
    def r_max(self) -> int:
        return max(self.rs)

    # ---- bit accounting (host-side floats, no device sync) ----------------
    def grad_uplink_bits_mean(self) -> float:
        """Per-client gradient uplink cost averaged over the fleet (§2.3:
        r_i coefficients for the data basis, d floats otherwise)."""
        if self.kind == "data_outer":
            return sum(r * FLOAT_BITS for r in self.rs) / len(self.rs)
        return self.d * FLOAT_BITS

    def transmission_bits_mean(self) -> float:
        """One-time basis shipping cost averaged over clients (rd floats
        for the data basis, d² for the eigenbasis; conventions are free)."""
        if self.kind == "data_outer":
            return sum(self.d * r * FLOAT_BITS for r in self.rs) / len(self.rs)
        if self.kind == "eigen":
            return float(self.d * self.d * FLOAT_BITS)
        return 0.0

    def coeff_count_mean(self) -> float:
        if self.kind == "data_outer":
            return sum(r * r for r in self.rs) / len(self.rs)
        if self.kind in ("symmetric", "psd"):
            return self.d * (self.d + 1) / 2
        return self.d * self.d

    def init_coeff_bits_mean(self, init_exact: bool) -> float:
        return self.coeff_count_mean() * FLOAT_BITS if init_exact else 0.0

    # ---- coefficient transforms (batched h / reconstruct) -----------------
    def h(self, A: torch.Tensor) -> torch.Tensor:
        """Batched coefficient matrices: A (n, d, d) → (n, d, d)."""
        if self.kind == "standard":
            return A
        if self.kind == "symmetric":
            return torch.tril(A)
        if self.kind == "psd":
            off = torch.tril(A, -1)
            diag_v = torch.diagonal(A, dim1=-2, dim2=-1)
            rowsum = A.sum(dim=-1) - diag_v
            eye = torch.eye(self.d, dtype=A.dtype, device=A.device)
            return off + eye * (diag_v - rowsum)[..., :, None]
        if self.kind in ROTATION_KINDS:
            return torch.einsum("ndr,nde,nes->nrs", self.Q, A, self.Q)
        out = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
        # the kernel route's float32 Γ is cast into the float64 array, as the
        # reference's ``out.at[...].set(gamma)`` does
        out[:, : self.r_max, : self.r_max] = _basis_project(self.V, A, self.project)
        return out

    def reconstruct(self, H: torch.Tensor) -> torch.Tensor:
        """Batched Σ_{jl} H_{jl} B^{jl}: H (n, d, d) → (n, d, d)."""
        if self.kind == "standard":
            return H
        if self.kind == "symmetric":
            return torch.tril(H) + torch.tril(H, -1).mT
        if self.kind == "psd":
            off = torch.tril(H, -1)
            sym_off = off + off.mT
            diag_v = torch.diagonal(H, dim1=-2, dim2=-1) + sym_off.sum(dim=-1)
            eye = torch.eye(self.d, dtype=H.dtype, device=H.device)
            return sym_off + eye * diag_v[..., :, None]
        if self.kind in ROTATION_KINDS:
            return torch.einsum("ndr,nrs,nes->nde", self.Q, H, self.Q)
        gamma = H[:, : self.r_max, : self.r_max]
        return torch.einsum("ndr,nrs,nes->nde", self.V, gamma, self.V)

    def server_reconstruct(self, H: torch.Tensor, lam: float) -> torch.Tensor:
        """`reconstruct` plus the analytic λI ridge for the data basis, as
        the server adds it; every other kind encodes the full Hessian."""
        out = self.reconstruct(H)
        if self.kind == "data_outer":
            out = out + lam * torch.eye(self.d, dtype=out.dtype, device=out.device)
        return out


def _basis_project(V: torch.Tensor, A: torch.Tensor, route: str = "einsum") -> torch.Tensor:
    """Γ = VᵀAV batched over clients: (n,d,r),(n,d,d) → (n,r,r).  The
    "einsum" route computes in float64; the "kernel" route in float32
    through `repro_torch.kernels.ops.basis_project` (the tiled-matmul
    kernel on the card)."""
    if route == "kernel":
        return ops.basis_project(V, A)
    return torch.einsum("ndr,nde,nes->nrs", V, A, V)


@dataclasses.dataclass
class TreeBatch:
    """Client-stacked batch for pytree workloads (BL-DNN): `data` is the
    pytree the loss consumes, every leaf stacked on a leading
    ``n_clients`` axis."""

    data: object
    n_clients: int

    def __post_init__(self):
        for leaf in tree_leaves(self.data):
            if leaf.dim() < 1 or leaf.shape[0] != self.n_clients:
                raise ValueError(
                    f"every TreeBatch leaf needs a leading n_clients={self.n_clients} "
                    f"axis; got shape {tuple(leaf.shape)}")

    @property
    def n(self) -> int:
        return self.n_clients


def tree_batch(data, n_clients: Optional[int] = None) -> TreeBatch:
    """Build a `TreeBatch` (``n_clients`` defaults to the first leaf's
    leading axis), validating the shared leading client axis."""
    leaves = tree_leaves(data)
    if not leaves:
        raise ValueError("TreeBatch needs at least one data leaf")
    n = leaves[0].shape[0] if n_clients is None else n_clients
    return TreeBatch(data=data, n_clients=int(n))


# --------------------------------------------------------------------------
# stacking a fleet
# --------------------------------------------------------------------------
def from_clients(clients: Sequence[glm.ClientData]) -> Optional[ClientBatch]:
    """Stack a homogeneous client list; None if shapes/λ differ."""
    clients = list(clients)
    if not clients:
        return None
    shape = clients[0].A.shape
    lam = clients[0].lam
    for c in clients:
        if c.A.shape != shape or tuple(c.b.shape) != (shape[0],) or c.lam != lam:
            return None
    return ClientBatch(A=torch.stack([c.A for c in clients]),
                       b=torch.stack([c.b for c in clients]), lam=lam)


def stack_bases(bases: Sequence[MatrixBasis],
                project: str = "einsum") -> Optional[BatchedBasis]:
    """Stack a homogeneous-kind basis list, its Γ on the `project` route;
    None if the kinds are mixed, or for a rotation whose clients do not
    share one Q."""
    bases = list(bases)
    if not bases:
        return None
    b0 = bases[0]
    if any(b.d != b0.d for b in bases):
        return None
    rs = tuple(b.d for b in bases)
    for kind, cls in CONVENTION_BASES.items():
        if all(type(b) is cls for b in bases):
            return BatchedBasis(kind=kind, d=b0.d, rs=rs, project=project)
    for cls, kind in ((DCTBasis, "dct"), (EigenBasis, "eigen")):
        if all(type(b) is cls for b in bases):
            if not all(b.Q is b0.Q or torch.equal(b.Q, b0.Q) for b in bases[1:]):
                return None
            return BatchedBasis(kind=kind, d=b0.d, rs=rs, project=project,
                                Q=torch.stack([b.Q for b in bases]))
    if all(type(b) is DataOuterBasis for b in bases):
        rs = tuple(b.r for b in bases)
        r_max = max(rs)
        V = torch.stack([torch.nn.functional.pad(b.V, (0, r_max - b.r))
                         for b in bases])                # zero cols beyond r_i
        return BatchedBasis(kind="data_outer", d=b0.d, rs=rs, V=V, project=project)
    return None


def shard_batch(batch, sl: slice):
    """The clients ``sl`` of a `ClientBatch` or `TreeBatch` (views)."""
    if isinstance(batch, TreeBatch):
        return TreeBatch(data=_tree_rows(batch.data, sl), n_clients=len(range(batch.n)[sl]))
    return ClientBatch(A=batch.A[sl], b=batch.b[sl], lam=batch.lam)


def _tree_rows(tree, sl: slice):
    if isinstance(tree, dict):
        return {k: _tree_rows(v, sl) for k, v in tree.items()}
    return tree[sl]


def shard_basis(basisb: BatchedBasis, sl: slice) -> BatchedBasis:
    """The clients ``sl`` of a `BatchedBasis`: its per-client factors
    sliced (views), ``rs`` kept whole (the bills are fleet averages)."""
    return dataclasses.replace(basisb, **{f: getattr(basisb, f)[sl] for f in ("V", "Q")
                                          if getattr(basisb, f) is not None})


# --------------------------------------------------------------------------
# host-resident client store (cohort streaming)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ClientStore:
    """The full fleet's data and per-client carry state, on the host.

    The stacked engine puts all n clients on the device; the
    cohort-streaming engine (`repro_torch.core.cohort`) keeps the fleet
    here, float64 numpy arrays in host memory, and each epoch moves only
    the sampled cohort's rows to the device.  ``state`` holds the
    client-stacked carry leaves between the rounds a client is sampled;
    an absent client's state stays frozen (Alg. 2–3), which is exactly
    what "rows not gathered this epoch do not move" gives."""

    A: np.ndarray             # (n, m, d) float64
    b: np.ndarray             # (n, m) float64
    lam: float
    state: dict = dataclasses.field(default_factory=dict)  # name -> (n, ...)

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[2]

    def gather_data(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side cohort gather: (A[idx], b[idx]) as fresh numpy arrays."""
        return self.A[idx], self.b[idx]

    def gather_batch(self, idx: np.ndarray, device=None) -> ClientBatch:
        """The cohort's `ClientBatch` on ``device`` (default: the CPU)."""
        A, b = self.gather_data(idx)
        return ClientBatch(A=torch.from_numpy(A).to(device), b=torch.from_numpy(b).to(device),
                           lam=self.lam)


def synthetic_store(seed: int, n_clients: int, m: int, d: int,
                    lam: float = 1e-3, noise: float = 0.1) -> ClientStore:
    """Vectorized synthetic logistic-regression fleet for the streaming
    engine: a planted model with flip-noise labels, drawn in one shot from
    numpy's ``default_rng(seed)`` as the reference draws it (rows are full
    rank: store-backed problems run the standard basis)."""
    rng = np.random.default_rng(seed)
    x_true = rng.standard_normal(d) / np.sqrt(d)
    A = rng.standard_normal((n_clients, m, d)) / np.sqrt(d)
    logits = A @ x_true
    p = 1.0 / (1.0 + np.exp(-logits))
    b = np.where(rng.random((n_clients, m)) < (1 - noise) * p + noise * 0.5,
                 1.0, -1.0)
    return ClientStore(A=np.asarray(A, np.float64),
                       b=np.asarray(b, np.float64), lam=lam)


# --------------------------------------------------------------------------
# batched GLM math (mirrors glm, vectorized over clients)
# --------------------------------------------------------------------------
def bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-client matvec (n, k, e) @ (n, e) → (n, k) as multiply+reduce, as
    the reference does: its result does not depend on the batch size."""
    return (M * v[:, None, :]).sum(dim=-1)


#: elements in one step of torch's widest CPU vector loop (two AVX-512
#: vectors of float64)
_CPU_STEP = 16


def rowwise(fn, z: torch.Tensor) -> torch.Tensor:
    """``fn(z)`` for an elementwise ``fn`` of a client-stacked (n, m) tensor,
    each client's values the same whatever n is.  torch's CPU loops run
    whole vector steps through SLEEF and the elements left over through the
    scalar libm, which can round another way, so a client's values would
    depend on where its row falls in the batch — on how many clients a
    sharded rank holds.  On the CPU each row is padded to whole steps, so
    every element takes the vector path (in one thread: a parallel loop
    cuts the range where it likes); the card computes every element alike,
    and takes ``fn(z)`` as it is."""
    pad = -z.shape[-1] % _CPU_STEP
    if z.device.type != "cpu" or pad == 0:
        return fn(z)
    return fn(torch.nn.functional.pad(z, (0, pad)))[..., :z.shape[-1]]


def _per_client_x(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a shared iterate (d,) to (n, d); pass (n, d) through."""
    if x.dim() == 1:
        return x.expand(batch.n, batch.d)
    return x


def losses(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    xb = _per_client_x(batch, x)
    z = bmv(batch.A, xb) * batch.b
    data = rowwise(lambda t: torch.logaddexp(torch.zeros_like(t), -t), z).mean(dim=1)
    return data + 0.5 * batch.lam * (xb * xb).sum(dim=1)


def global_loss(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    return losses(batch, x).mean()


def grads(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    """Per-client gradients (n, d) at a shared or per-client iterate."""
    xb = _per_client_x(batch, x)
    z = bmv(batch.A, xb) * batch.b
    coef = -batch.b * rowwise(glm.sigmoid, -z)
    # multiply+reduce over the samples, as `bmv`: the batched GEMV an einsum
    # would run picks its cuBLAS algorithm by the number of clients, and a
    # client's gradient would change bits with it
    return (batch.A * coef[..., None]).sum(dim=1) / batch.m + batch.lam * xb


def global_grad(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    return grads(batch, x).mean(dim=0)


def hess_weights(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    xb = _per_client_x(batch, x)
    z = bmv(batch.A, xb) * batch.b
    s = rowwise(glm.sigmoid, z)
    return s * (1.0 - s)


def hess_data_part(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    """Per-client data-part Hessians (n, d, d) — no λI term (§2.3)."""
    w = hess_weights(batch, x)
    return torch.einsum("nmd,nm,nme->nde", batch.A, w, batch.A) / batch.m


def _ridge(batch: ClientBatch, like: torch.Tensor) -> torch.Tensor:
    return batch.lam * torch.eye(batch.d, dtype=like.dtype, device=like.device)


def hess(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    """Per-client full Hessians (n, d, d)."""
    H = hess_data_part(batch, x)
    return H + _ridge(batch, H)


def global_hess_fused(batch: ClientBatch, x: torch.Tensor) -> torch.Tensor:
    """Global Hessian mean_i ∇²f_i(x) without the (n, d, d) per-client
    intermediate: one (n·m, d)-shaped weighted Gram contraction.  Agrees
    with the mean of `hess` to f64 roundoff, not bitwise — for the reference
    optimum, not the round engine."""
    w = hess_weights(batch, x)                      # (n, m)
    Aw = batch.A * w[..., None]                     # (n, m, d)
    H = torch.einsum("nmd,nme->de", Aw, batch.A) / (batch.n * batch.m)
    return H + _ridge(batch, H)


def newton_solve_fused(batch: ClientBatch, x0: torch.Tensor,
                       iters: int = 20) -> torch.Tensor:
    """Reference optimum x* by full Newton on the stacked fleet, with the
    low-memory `global_hess_fused` each iteration (fig1-xl's solver)."""
    x = x0
    for _ in range(iters):
        g = global_grad(batch, x)
        H = global_hess_fused(batch, x)
        x = x - torch.linalg.solve(H, g)
    return x


def hess_coeff_target(basisb: BatchedBasis, batch: ClientBatch,
                      x: torch.Tensor) -> torch.Tensor:
    """Batched h^i(∇²f_i): the data basis sees only the data part (the
    ridge is added server-side), the standard basis the full Hessian."""
    if basisb.kind == "data_outer":
        return basisb.h(hess_data_part(batch, x))
    return basisb.h(hess(batch, x))


# --------------------------------------------------------------------------
# r-dim coordinate-space fast path (§2.3): never materialize the d×d Hessian
# --------------------------------------------------------------------------
def basis_AV(basisb: BatchedBasis, batch: ClientBatch) -> torch.Tensor:
    """Per-client data rotated into the basis: (n, m, r_max), once per run."""
    return torch.einsum("nmd,ndr->nmr", batch.A, basisb.V)


def hess_coeff_block(basisb: BatchedBasis, batch: ClientBatch, x: torch.Tensor,
                     AV: torch.Tensor) -> torch.Tensor:
    """Γ_i = (AᵢVᵢ)ᵀ Dᵢ (AᵢVᵢ)/m natively (n, r, r): the data-basis
    coefficient target in O(n·m·r²) with no (n, d, d) intermediate."""
    w = hess_weights(batch, x)
    return torch.einsum("nmr,nm,nms->nrs", AV, w, AV) / batch.m


def reconstruct_block(basisb: BatchedBasis, G: torch.Tensor) -> torch.Tensor:
    """(n, r, r) block coefficients → (n, d, d) data-part Hessians."""
    return torch.einsum("ndr,nrs,nes->nde", basisb.V, G, basisb.V)
