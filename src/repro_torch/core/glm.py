"""Generalized linear models for the paper's experiments (Eq. 16).

Port of `repro.core.glm`.  Regularized logistic regression:
    f(x) = (1/n) Σ_i f_i(x) + (λ/2)‖x‖²,
    f_i(x) = (1/m) Σ_j log(1 + exp(−b_ij a_ijᵀ x)),
with the ridge folded evenly into every client, so
∇²f_i^λ = (1/m) Aᵀ D A + λI with D = diag(φ″).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .. import device as _device


@dataclasses.dataclass
class ClientData:
    A: torch.Tensor  # (m, d) features, float64
    b: torch.Tensor  # (m,) labels in {−1, +1}, float64
    lam: float       # ridge coefficient (shared)


def sigmoid(t: torch.Tensor) -> torch.Tensor:
    # the tanh form of the reference (not torch.sigmoid): same rounding
    return 0.5 * (torch.tanh(t / 2.0) + 1.0)


def loss(data: ClientData, x: torch.Tensor) -> torch.Tensor:
    z = data.A @ x * data.b
    return (torch.logaddexp(torch.zeros_like(z), -z).mean()
            + 0.5 * data.lam * torch.dot(x, x))


def grad(data: ClientData, x: torch.Tensor) -> torch.Tensor:
    z = data.A @ x * data.b
    coef = -data.b * sigmoid(-z)  # φ' = −b σ(−b aᵀx)
    return data.A.T @ coef / data.A.shape[0] + data.lam * x


def hess_diag_weights(data: ClientData, x: torch.Tensor) -> torch.Tensor:
    """φ″(a_jᵀx) for every sample: σ(z)(1−σ(z)) with z = b aᵀx (b²=1)."""
    z = data.A @ x * data.b
    s = sigmoid(z)
    return s * (1.0 - s)


def hess_data_part(data: ClientData, x: torch.Tensor) -> torch.Tensor:
    """Hessian without the λI term (lives in the data subspace — §2.3)."""
    w = hess_diag_weights(data, x)
    return (data.A * w[:, None]).T @ data.A / data.A.shape[0]


def hess(data: ClientData, x: torch.Tensor) -> torch.Tensor:
    d = data.A.shape[1]
    return hess_data_part(data, x) + data.lam * torch.eye(
        d, dtype=x.dtype, device=x.device)


def global_loss(clients: List[ClientData], x: torch.Tensor) -> torch.Tensor:
    return torch.stack([loss(c, x) for c in clients]).mean()


def global_grad(clients: List[ClientData], x: torch.Tensor) -> torch.Tensor:
    return torch.stack([grad(c, x) for c in clients]).mean(dim=0)


def global_hess(clients: List[ClientData], x: torch.Tensor) -> torch.Tensor:
    return torch.stack([hess(c, x) for c in clients]).mean(dim=0)


def newton_solve(clients: List[ClientData], x0: torch.Tensor,
                 iters: int = 20) -> torch.Tensor:
    """Reference optimum: the paper uses the 20th Newton iterate as x*."""
    x = x0
    for _ in range(iters):
        g = global_grad(clients, x)
        Hm = global_hess(clients, x)
        x = x - torch.linalg.solve(Hm, g)
    return x


def make_synthetic(seed: int, n_clients: int, m: int, d: int, r: int,
                   lam: float = 1e-3, noise: float = 0.1,
                   heterogeneity: float = 0.5, *,
                   device=None) -> List[ClientData]:
    """Low-intrinsic-dimension federated logistic regression data on
    `device`: each client's rows live in an r-dim subspace (a per-client
    rotation of a shared one), labels come from a planted model with flip
    noise.  The arrays are made in numpy with the reference's
    `default_rng` call sequence, call for call, so a seed gives the
    reference data bit for bit."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    Q_global, _ = np.linalg.qr(rng.standard_normal((d, r)))
    x_true = rng.standard_normal(d) / np.sqrt(d)
    out = []
    for _ in range(n_clients):
        P, _ = np.linalg.qr(
            (1 - heterogeneity) * Q_global + heterogeneity * rng.standard_normal((d, r))
        )
        alpha = rng.standard_normal((m, r))
        A = alpha @ P.T                      # rows ∈ span(P) exactly, rank ≤ r
        logits = A @ x_true
        p = 1.0 / (1.0 + np.exp(-logits))
        b = np.where(rng.random(m) < (1 - noise) * p + noise * 0.5, 1.0, -1.0)
        out.append(ClientData(A=torch.as_tensor(A, dtype=torch.float64, device=dev),
                              b=torch.as_tensor(b, dtype=torch.float64, device=dev),
                              lam=lam))
    return out


#: Table 2's regimes at the reference's scaled-down sizes
TABLE2 = {
    "a1a": dict(n_clients=16, m=100, d=123, r=64),
    "phishing": dict(n_clients=10, m=11, d=68, r=35),
    "madelon-mini": dict(n_clients=10, m=40, d=200, r=60),
    "w2a-mini": dict(n_clients=10, m=69, d=300, r=59),
}


def make_table2(name: str, seed: int = 0, lam: float = 1e-3, *,
                device=None) -> List[ClientData]:
    """The named `TABLE2` regime through `make_synthetic`."""
    return make_synthetic(seed=seed, lam=lam, device=device, **TABLE2[name])
