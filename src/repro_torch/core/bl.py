"""BL1 (Algorithm 1) — public API and backend dispatch; port of
`repro.core.bl`.

`bl1` takes ``backend="auto"|"fast"|"fast+sharded"|"reference"``.  The
port runs "auto" and "fast" on its single-device fast path
(`repro_torch.core.batched`); "fast+sharded" and "reference" raise
`NotImplementedError` until ROADMAP.md §1 items 13 and 17 port them
(`run_fast`, shared with `repro_torch.core.baselines.newton`).

Conventions are the reference's: compression acts on coefficient matrices
h^i(∇²f_i) in the client's basis; with the data basis the Hessian's data
part is encoded and the ridge λI is added analytically server-side.
`History` records per round f(z)−f*, cumulative uplink bits/node and
cumulative downlink bits/node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from .. import device as _device
from . import glm
from .basis import DataOuterBasis, MatrixBasis
from .compressors import Compressor

_BACKENDS = ("auto", "fast", "fast+sharded", "reference")


def proj_mu(A: torch.Tensor, mu: float) -> torch.Tensor:
    """[A]_μ: projection onto {A = Aᵀ, A ⪰ μI} (used by BL1)."""
    S = (A + A.T) / 2.0
    w, V = torch.linalg.eigh(S)
    return (V * torch.clamp(w, min=mu)) @ V.T


@dataclasses.dataclass
class History:
    gaps: List[float]
    up_bits: List[float]
    down_bits: List[float]
    #: per-leg cumulative bit streams keyed by `comm.CommLedger` leg name
    legs: Optional[Dict[str, List[float]]] = None
    #: extra named evaluation streams beyond the gap (None for GLM methods)
    metrics: Optional[Dict[str, List[float]]] = None


def _to(device, clients, bases, x0, x_star):
    """The run's inputs on `device` (a no-op for tensors already there);
    ``bases`` may be None."""
    clients = [glm.ClientData(A=c.A.to(device), b=c.b.to(device), lam=c.lam)
               for c in clients]
    if bases is not None:
        bases = [DataOuterBasis(V=b.V.to(device)) if isinstance(b, DataOuterBasis)
                 else b for b in bases]
    return clients, bases, x0.to(device), x_star.to(device)


def run_fast(backend: str, device, clients, bases, x0, x_star, fast):
    """Dispatch a public entry point: validate ``backend``, move the inputs
    to the resolved device and run ``fast(clients, bases, x0, x_star)`` on
    the single-device fast path.  "reference" and "fast+sharded" raise
    until their ROADMAP items; a fleet the fast path cannot stack raises
    `batched.FastPathUnavailable` under "fast" and `NotImplementedError`
    under "auto", whose reference fallback is not ported."""
    from . import batched

    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if backend == "reference":
        raise NotImplementedError(
            "backend='reference' (the op-by-op loops) is not ported yet: "
            "ROADMAP.md §1 item 17 brings it")
    if backend == "fast+sharded":
        raise NotImplementedError(
            "backend='fast+sharded' is not ported yet: ROADMAP.md §1 item 13 "
            "(torch.distributed reducer) brings it")
    dev = _device.resolve(device)
    try:
        return fast(*_to(dev, clients, bases, x0, x_star))
    except batched.FastPathUnavailable as e:
        if backend == "auto":
            raise NotImplementedError(
                f"{e}: the reference backend that 'auto' falls back to is "
                "not ported yet (ROADMAP.md §1 item 17)") from e
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
    kernel, the reference's ``REPRO_BL_PALLAS=1`` route).  ``seed`` is
    accepted for the reference's signature; the ported deterministic
    configurations (Top-K, Rank-R or Identity compressors, p = 1) draw
    nothing from it.

    Returns a `History` with per-round gaps, cumulative per-node uplink and
    downlink bits, and the per-leg `CommLedger` streams in ``legs``."""
    from . import batched

    def fast(clients, bases, x0, x_star):
        return batched.bl1_fast(
            clients, bases, hess_comp, model_comp, x0, x_star, steps,
            alpha=alpha, eta=eta, p=p, mu=mu, seed=seed,
            init_exact_hessian=init_exact_hessian, stream=stream,
            basis_project=basis_project)

    return run_fast(backend, device, clients, bases, x0, x_star, fast)
