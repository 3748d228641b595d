"""The methods the paper compares against (§6, §A) — port of
`repro.core.baselines`, so far Newton (Table 1's naive and data-basis
columns) and NewtonLearn-1 (`nl1`).  GD, DIANA, ADIANA, Local-GD, DORE
and FedNL-BAG come with ROADMAP.md §1 item 10; FedNL itself is
`repro_torch.core.bl.bl1` with the standard basis and a Rank-R Hessian
compressor.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import device as _device
from . import client_batch, comm, glm, prng
from .basis import MatrixBasis
from .bl import History, _to, proj_mu, run_fast
from .comm import FLOAT_BITS
from .compressors import RandK


def newton(
    clients: Sequence[glm.ClientData],
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    bases: Optional[Sequence[MatrixBasis]] = None,
    backend: str = "auto",
    *,
    device=None,
    basis_project: str = "einsum",
) -> History:
    """Classical Newton.  ``bases=None`` sends d² + d floats a round
    (§2.1); per-client `DataOuterBasis` sends r² + r (§2.3, the §A.4
    comparison), after a one-time shipment of the basis.

    Args are the reference's (`repro.core.baselines.newton`), plus
    ``device`` (``None`` means ``"cuda"``, which raises without a GPU) and
    ``basis_project``, the route of Γ = VᵀAV: "einsum" (float64, the
    default) or "kernel" (float32 through the tiled-matmul kernel).
    "auto" and "fast" run the single-device fast path; bases of another
    kind raise `batched.FastPathUnavailable` under "fast" and
    `NotImplementedError` under "auto"."""
    from . import batched

    def fast(clients, bases, x0, x_star):
        return batched.newton_fast(clients, x0, x_star, steps, bases=bases,
                                   basis_project=basis_project)

    return run_fast(backend, device, clients, bases, x0, x_star, fast)


def nl1(
    clients: Sequence[glm.ClientData],
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    k: int = 1,
    seed: int = 0,
    *,
    device=None,
) -> History:
    """NewtonLearn-1 [Islamov et al. 2021]: each client learns its m
    per-sample φ″ coefficients with Rand-K (ω = m/K − 1, α = 1/(ω+1)); the
    server, which knows the training data (the method's stated privacy
    cost, Table 1), solves with the learned Hessian projected to ⪰ λI.

    Args are the reference's (`repro.core.baselines.nl1`), plus ``device``
    (``None`` means ``"cuda"``).  The reference's per-client key chain
    (``key, sk = split(key)`` client after client, every round) is
    unrolled on the host and the fleet's Rand-K draws run as one batched
    call; the fleet must be homogeneous (one m and λ)."""
    dev = _device.resolve(device)
    clients, _, x0, x_star = _to(dev, clients, None, x0, x_star)
    batch = client_batch.from_clients(clients)
    if batch is None:
        raise ValueError("nl1 needs a homogeneous fleet (one m and λ)")
    n, m, d = batch.n, batch.m, batch.d
    comp = RandK(k=k)
    alpha = 1.0 / (m / min(k, m))
    eye = torch.eye(d, dtype=x0.dtype, device=dev)
    f_star = float(client_batch.global_loss(batch, x_star))
    key = prng.PRNGKey(seed)
    x = x0
    hcoef = client_batch.hess_weights(batch, x0)           # (n, m), learned φ″
    up = float(m * FLOAT_BITS)                             # ship h⁰ (data known)
    hist = History([], [], [])
    for _ in range(steps):
        hist.append(float(client_batch.global_loss(batch, x)) - f_star, up, 0.0)
        g = client_batch.global_grad(batch, x)
        H = (torch.einsum("nmd,nm,nme->nde", batch.A, hcoef, batch.A) / m).sum(dim=0) / n
        x = x - torch.linalg.solve(proj_mu(H + batch.lam * eye, batch.lam), g)
        sks = []
        for _ in range(n):
            key, sk = prng.split(key)
            sks.append(sk)
        S, counts = comp.compress(torch.stack(sks),
                                  client_batch.hess_weights(batch, x) - hcoef)
        hcoef = hcoef + alpha * S
        step_bits = 0.0
        for b in comm.price(comp.wire, counts).tolist():
            step_bits += b
        up += step_bits / n + d * FLOAT_BITS               # gradients every step
    return hist
