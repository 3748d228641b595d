"""BL1 / BL2 / BL3 (Algorithms 1–3) — public API and backend dispatch;
port of `repro.core.bl`.

`bl1`, `bl2` and `bl3` take ``backend="auto"|"fast"|"fast+sharded"|
"reference"``, dispatched as the reference dispatches them (`dispatch`,
shared with `repro_torch.core.baselines`): "fast" runs the single-device
fast path (`repro_torch.core.batched`) and raises
`batched.FastPathUnavailable` for a fleet it cannot stack, "fast+sharded"
the same path with the clients sharded over the ranks of a
`torch.distributed` world (`rounds.ShardedReducer`; one process is a
one-rank world), ``exact`` choosing its collectives as the reference's
does, "reference" the op-by-op loops (`repro_torch.core.bl_reference`), and
"auto" the fast path, falling back to the loops on
`batched.FastPathUnavailable`.  Draws follow `repro_torch.core.prng` under
the caller's `prng.threefry_partitionable` setting (default False, the
setting of every committed artifact).

Conventions are the reference's: compression acts on coefficient matrices
h^i(∇²f_i) in the client's basis; with the data basis the Hessian's data
part is encoded and the ridge λI is added analytically server-side.
`History` records per round f(z)−f*, cumulative uplink bits/node and
cumulative downlink bits/node.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from .. import device as _device
from . import glm
from .basis import DataOuterBasis, MatrixBasis, RotationBasis, basis_transmission_bits
from .comm import FLOAT_BITS
from .compressors import Compressor

_BACKENDS = ("auto", "fast", "fast+sharded", "reference")


def proj_mu(A: torch.Tensor, mu: float) -> torch.Tensor:
    """[A]_μ: projection onto {A = Aᵀ, A ⪰ μI} (used by BL1)."""
    S = (A + A.T) / 2.0
    w, V = torch.linalg.eigh(S)
    return (V * torch.clamp(w, min=mu)) @ V.T


def _sym(A: torch.Tensor) -> torch.Tensor:
    return (A + A.T) / 2.0


@dataclasses.dataclass
class History:
    gaps: List[float]
    up_bits: List[float]
    down_bits: List[float]
    #: per-leg cumulative bit streams keyed by `comm.CommLedger` leg name
    legs: Optional[Dict[str, List[float]]] = None
    #: extra named evaluation streams beyond the gap (None for GLM methods)
    metrics: Optional[Dict[str, List[float]]] = None
    #: per-round `rounds.EVENT_*` bitmasks; the batch drivers leave it None
    events: Optional[List[int]] = None
    #: per round, the global indices of the clients that uploaded (the
    #: cohort-streaming engine's `CohortEngine.uploads`); None elsewhere
    uploads: Optional[List[List[int]]] = None

    def append(self, gap, up, down):
        self.gaps.append(float(max(gap, 0.0)))
        self.up_bits.append(float(up))
        self.down_bits.append(float(down))


# --------------------------------------------------------------------------
# one client's basis arithmetic (the reference loops, `bl_reference`)
# --------------------------------------------------------------------------
def _grad_uplink_bits(basis: MatrixBasis) -> float:
    return (basis.r if isinstance(basis, DataOuterBasis) else basis.d) * FLOAT_BITS


def _client_hcoef(basis: MatrixBasis, data: glm.ClientData, x: torch.Tensor) -> torch.Tensor:
    if isinstance(basis, DataOuterBasis):
        return basis.h(glm.hess_data_part(data, x))
    return basis.h(glm.hess(data, x))


def _server_reconstruct(basis: MatrixBasis, L: torch.Tensor, lam: float) -> torch.Tensor:
    H = basis.reconstruct(L)
    if isinstance(basis, DataOuterBasis):
        H = H + lam * torch.eye(basis.d, dtype=H.dtype, device=H.device)
    return H


def _init_bits(basis: MatrixBasis, init_exact: bool) -> float:
    bits = basis_transmission_bits(basis)
    if init_exact:
        bits += basis.n_coeff * FLOAT_BITS
    return bits


# --------------------------------------------------------------------------
# PSD-basis helpers of Example 5.1 (§5), on (..., d, d) stacks
# --------------------------------------------------------------------------
def _psd_sum_matrix(d: int, dtype, device) -> torch.Tensor:
    """Σ_{j,l} B^{jl} for the PSD basis (ordered pairs + diagonal)."""
    return (2.0 * torch.ones((d, d), dtype=dtype, device=device)
            + (2.0 * d - 3.0) * torch.eye(d, dtype=dtype, device=device))


def _psd_h_tilde(A: torch.Tensor) -> torch.Tensor:
    """h̃(A): symmetric coefficient matrix (halved off-diagonals) — §5."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    off = (A - torch.diag_embed(diag)) / 2.0
    rowsum = A.sum(dim=-1) - diag
    return off + torch.diag_embed(diag - rowsum)


def _psd_reconstruct_full(M: torch.Tensor) -> torch.Tensor:
    """Σ_{j,l} M_{jl} B^{jl} over all ordered pairs, for symmetric M."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    off = M - torch.diag_embed(diag)
    return 2.0 * off + torch.diag_embed(diag + 2.0 * off.sum(dim=-1))


def _basis_to(device, b):
    """A basis with its tensors on `device`."""
    if isinstance(b, DataOuterBasis):
        return DataOuterBasis(V=b.V.to(device))
    if isinstance(b, RotationBasis):
        moved = copy.copy(b)
        moved.Q = b.Q.to(device)
        return moved
    return b


def _to(device, clients, bases, x0, x_star):
    """The run's inputs on `device` (a no-op for tensors already there);
    ``bases`` may be None.  A basis object shared by several clients stays
    shared."""
    clients = [glm.ClientData(A=c.A.to(device), b=c.b.to(device), lam=c.lam)
               for c in clients]
    if bases is not None:
        moved = {}
        for b in bases:
            if id(b) not in moved:
                moved[id(b)] = _basis_to(device, b)
        bases = [moved[id(b)] for b in bases]
    return clients, bases, x0.to(device), x_star.to(device)


def dispatch(backend: str, device, clients, bases, x0, x_star, fast, reference):
    """Dispatch a public entry point, as the reference's ``_dispatch``
    does: validate ``backend``, move the inputs to the resolved device
    (``bases`` may be None), then run ``fast(clients, bases, x0, x_star,
    sharded=backend == "fast+sharded")`` or, for "reference",
    ``reference(clients, bases, x0, x_star)``; "auto" falls back to
    ``reference`` when the fast path raises `batched.FastPathUnavailable`,
    "fast" and "fast+sharded" let it raise."""
    from . import batched

    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    args = _to(_device.resolve(device), clients, bases, x0, x_star)
    if backend == "reference":
        return reference(*args)
    try:
        return fast(*args, sharded=backend == "fast+sharded")
    except batched.FastPathUnavailable:
        if backend == "auto":
            return reference(*args)
        raise


def bl1(
    clients: Sequence[glm.ClientData],
    bases: Sequence[MatrixBasis],
    hess_comp: Sequence[Compressor],
    model_comp: Compressor,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    alpha: float = 1.0,
    eta: float = 1.0,
    p: float = 1.0,
    mu: Optional[float] = None,
    seed: int = 0,
    init_exact_hessian: bool = True,
    backend: str = "auto",
    stream=None,
    exact: bool = True,
    *,
    device=None,
    basis_project: str = "einsum",
) -> History:
    """Basis Learn with Bidirectional Compression (Algorithm 1).

    Args are the reference's (`repro.core.bl.bl1`), plus ``device``: the
    run's device, ``None`` meaning ``"cuda"`` (raises without a GPU);
    inputs elsewhere are moved there; and ``basis_project``, the route of
    the data basis's Γ = VᵀAV in the full (n, d, d) layout: "einsum"
    (float64, the default) or "kernel" (float32 through the tiled-matmul
    kernel, the reference's ``REPRO_BL_PALLAS=1`` route).  ``seed`` keys
    the rounds: the fleet-wide ξ for p < 1 and any stochastic compressor.
    ``exact`` selects the "fast+sharded" reducer's collectives: the
    bitwise gather (default) or the spec's `rounds.ReducePlan`; ignored
    off that backend.

    Returns a `History` with per-round gaps, cumulative per-node uplink and
    downlink bits, and the per-leg `CommLedger` streams in ``legs`` (None
    from the reference loops, which ignore ``stream``, ``exact`` and
    ``basis_project``: they project in float64 as the reference's do)."""
    from . import batched, bl_reference

    kw = dict(alpha=alpha, eta=eta, p=p, mu=mu, seed=seed,
              init_exact_hessian=init_exact_hessian)

    def fast(clients, bases, x0, x_star, sharded):
        return batched.bl1_fast(clients, bases, hess_comp, model_comp, x0, x_star, steps,
                                stream=stream, basis_project=basis_project, sharded=sharded,
                                exact=exact, **kw)

    def reference(clients, bases, x0, x_star):
        return bl_reference.bl1_reference(clients, bases, hess_comp, model_comp, x0, x_star,
                                          steps, **kw)

    return dispatch(backend, device, clients, bases, x0, x_star, fast, reference)


def bl2(
    clients: Sequence[glm.ClientData],
    bases: Sequence[MatrixBasis],
    hess_comp: Sequence[Compressor],
    model_comp: Sequence[Compressor],
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    alpha: float = 1.0,
    eta: float = 1.0,
    p: float = 1.0,
    tau: Optional[int] = None,
    seed: int = 0,
    init_exact_hessian: bool = True,
    backend: str = "auto",
    stream=None,
    exact: bool = True,
    *,
    device=None,
) -> History:
    """Basis Learn with Bidirectional Compression and Partial Participation
    (Algorithm 2).  StandardBasis ≡ FedNL-PP (Rank-R, identity model comp).

    Args are the reference's (`repro.core.bl.bl2`): ``model_comp`` is per
    client (client-individual z_i streams), ``tau`` the expected
    participants a round (Bernoulli(τ/n) with a force-one-client fallback;
    None is full participation), ``p`` the per-client gradient-refresh
    probability, ``exact`` the "fast+sharded" reducer's collectives (as in
    `bl1`); plus ``device`` (``None`` means ``"cuda"``)."""
    from . import batched, bl_reference

    kw = dict(alpha=alpha, eta=eta, p=p, tau=tau, seed=seed,
              init_exact_hessian=init_exact_hessian)

    def fast(clients, bases, x0, x_star, sharded):
        return batched.bl2_fast(clients, bases, hess_comp, model_comp, x0, x_star, steps,
                                stream=stream, sharded=sharded, exact=exact, **kw)

    def reference(clients, bases, x0, x_star):
        return bl_reference.bl2_reference(clients, bases, hess_comp, model_comp, x0, x_star,
                                          steps, **kw)

    return dispatch(backend, device, clients, bases, x0, x_star, fast, reference)


def bl3(
    clients: Sequence[glm.ClientData],
    hess_comp: Sequence[Compressor],
    model_comp: Sequence[Compressor],
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    alpha: float = 1.0,
    eta: float = 1.0,
    p: float = 1.0,
    tau: Optional[int] = None,
    c: float = 1e-8,
    option: int = 2,
    seed: int = 0,
    backend: str = "auto",
    stream=None,
    exact: bool = True,
    *,
    device=None,
) -> History:
    """BL3 with the PSD basis of Example 5.1 (both β options, Algorithm 3).

    Args are `bl2`'s without ``bases`` (the PSD basis is built in) and
    ``init_exact_hessian`` (BL3 starts from the exact h̃), plus ``c``, the
    γ_i floor (γ_i = max(c, max|L_i|)), and ``option``, the β_i candidate
    (1: previous-iterate numerator; 2: current target)."""
    from . import batched, bl_reference

    kw = dict(alpha=alpha, eta=eta, p=p, tau=tau, c=c, option=option, seed=seed)

    def fast(clients, _bases, x0, x_star, sharded):
        return batched.bl3_fast(clients, hess_comp, model_comp, x0, x_star, steps,
                                stream=stream, sharded=sharded, exact=exact, **kw)

    def reference(clients, _bases, x0, x_star):
        return bl_reference.bl3_reference(clients, hess_comp, model_comp, x0, x_star, steps,
                                          **kw)

    return dispatch(backend, device, clients, None, x0, x_star, fast, reference)
