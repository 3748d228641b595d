"""Op-by-op reference backend for BL1 / BL2 / BL3 (Algorithms 1–3) — port
of `repro.core.bl_reference`.

These are the paper-faithful Python loops, loop for loop as the reference
writes them: one ``for i in range(n)`` over clients a round, the key chain
``key, sk = split(key)`` advanced per client and per leg in the reference's
order on the host (`repro_torch.core.prng`, jax's threefry bit for bit), the
gaps and bit counts as Python floats, `History.legs` left None.  Each
client's compressor call is the single-client adapter
(`Compressor.__call__`): on the card a Top-K leg runs kernel 1 on the
client's ``(1, T)`` row, Rank-R the SVD of cuSOLVER.  They are the ground
truth the fast path is held to — do not optimise them.

Use them through `repro_torch.core.bl.bl1` / `bl2` / `bl3` with
``backend="reference"`` (or ``"auto"`` on a fleet the fast path cannot
stack).  Inputs are on the run's device already.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import glm, prng
from .basis import MatrixBasis
from .bl import (History, _client_hcoef, _grad_uplink_bits, _init_bits, _psd_h_tilde,
                 _psd_reconstruct_full, _psd_sum_matrix, _server_reconstruct, _sym, proj_mu)
from .comm import FLOAT_BITS
from .compressors import Compressor


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _fro(A: torch.Tensor) -> float:
    return float(torch.linalg.matrix_norm(A, "fro"))


def _participants(key: torch.Tensor, tau: int, n: int) -> np.ndarray:
    """`rounds.participation`'s draw as the loops make it: the mask and the
    fallback index from the two split keys of ``key``."""
    sk_mask, sk_idx = prng.split(key)
    part = prng.bernoulli(sk_mask, tau / n, (n,)).numpy().copy()
    if not part.any():
        part[int(prng.randint(sk_idx, (), 0, n))] = True
    return part


# --------------------------------------------------------------------------
# BL1 — Algorithm 1
# --------------------------------------------------------------------------
def bl1_reference(
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
) -> History:
    """Basis Learn with Bidirectional Compression.

    StandardBasis + Rank-R + identity model compressor ≡ FedNL (option 1);
    Top-K model compressor ≡ FedNL-BC.
    """
    clients = list(clients)
    n = len(clients)
    d = x0.shape[0]
    lam = clients[0].lam
    mu = lam if mu is None else mu
    key = prng.PRNGKey(seed)
    f_star = float(glm.global_loss(clients, x_star))

    z = x0
    w = x0
    if init_exact_hessian:
        L = [_client_hcoef(bases[i], clients[i], x0) for i in range(n)]
    else:
        L = [torch.zeros((d, d), dtype=x0.dtype, device=x0.device) for _ in range(n)]
    H = sum(_server_reconstruct(bases[i], L[i], lam) for i in range(n)) / n
    grad_w = glm.global_grad(clients, w)
    xi = 1

    # per-client ranks may differ (heterogeneous data bases) — average
    up = sum(_init_bits(b, init_exact_hessian) for b in bases) / n
    grad_bits = sum(_grad_uplink_bits(b) for b in bases) / n
    down = 0.0
    hist = History([], [], [])

    for _ in range(steps):
        hist.append(float(glm.global_loss(clients, z)) - f_star, up, down)

        Hmu = proj_mu(H, mu)
        # gradient leg
        if xi == 1:
            w = z
            grad_w = glm.global_grad(clients, w)
            g = grad_w
            up += grad_bits
        else:
            g = Hmu @ (z - w) + grad_w

        # Hessian-coefficient learning (clients → server)
        H_delta = torch.zeros((d, d), dtype=x0.dtype, device=x0.device)
        step_bits = 0.0
        for i in range(n):
            key, sk = prng.split(key)
            target = _client_hcoef(bases[i], clients[i], z)
            S, bits = hess_comp[i](sk, target - L[i])
            L[i] = L[i] + alpha * S
            H_delta = H_delta + bases[i].reconstruct(alpha * S)
            step_bits += float(bits)
        up += step_bits / n

        # server model step + broadcast
        x_next = z - torch.linalg.solve(Hmu, g)
        H = H + H_delta / n
        key, sk = prng.split(key)
        v, vbits = model_comp(sk, x_next - z)
        down += float(vbits)
        z = z + eta * v
        key, sk = prng.split(key)
        xi = 1 if p >= 1.0 else int(prng.bernoulli(sk, p))

    return hist


# --------------------------------------------------------------------------
# BL2 — Algorithm 2
# --------------------------------------------------------------------------
def bl2_reference(
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
) -> History:
    """Basis Learn with Bidirectional Compression and Partial Participation.

    StandardBasis ≡ FedNL-PP (with Rank-R compressor, identity model comp).
    """
    clients = list(clients)
    n = len(clients)
    d = x0.shape[0]
    lam = clients[0].lam
    tau = n if tau is None else tau
    key = prng.PRNGKey(seed)
    f_star = float(glm.global_loss(clients, x_star))
    eye = _eye(d, x0)

    def full_hess(i, x):
        return glm.hess(clients[i], x)

    z = [x0 for _ in range(n)]
    w = [x0 for _ in range(n)]
    if init_exact_hessian:
        L = [_client_hcoef(bases[i], clients[i], x0) for i in range(n)]
    else:
        L = [torch.zeros((d, d), dtype=x0.dtype, device=x0.device) for _ in range(n)]
    Hi = [_server_reconstruct(bases[i], L[i], lam) for i in range(n)]
    li = [_fro(_sym(Hi[i]) - full_hess(i, w[i])) for i in range(n)]
    gi = [(_sym(Hi[i]) + li[i] * eye) @ w[i] - glm.grad(clients[i], w[i]) for i in range(n)]
    H = sum(Hi) / n
    l_avg = sum(li) / n
    g = sum(gi) / n

    up = sum(_init_bits(b, init_exact_hessian) for b in bases) / n
    down = 0.0
    hist = History([], [], [])

    for _ in range(steps):
        x_cur = torch.linalg.solve(_sym(H) + l_avg * eye, g)
        hist.append(float(glm.global_loss(clients, x_cur)) - f_star, up, down)

        key, sk = prng.split(key)
        # rounds.participation's draw: mask and fallback index from SPLIT keys
        part = _participants(sk, tau, n)

        step_up = 0.0
        step_down = 0.0
        for i in range(n):
            if not part[i]:
                continue
            key, sk = prng.split(key)
            v_i, vbits = model_comp[i](sk, x_cur - z[i])
            step_down += float(vbits)
            z[i] = z[i] + eta * v_i

            key, sk = prng.split(key)
            target = _client_hcoef(bases[i], clients[i], z[i])
            S, bits = hess_comp[i](sk, target - L[i])
            step_up += float(bits)
            L_new = L[i] + alpha * S
            Hi_new = Hi[i] + bases[i].reconstruct(alpha * S)
            li_new = _fro(_sym(Hi_new) - full_hess(i, z[i]))
            key, sk = prng.split(key)
            xi = 1 if p >= 1.0 else int(prng.bernoulli(sk, p))
            if xi == 1:
                w[i] = z[i]
                gi_new = (_sym(Hi_new) + li_new * eye) @ w[i] - glm.grad(clients[i], w[i])
                step_up += d * FLOAT_BITS  # g_i^{k+1} − g_i^k
            else:
                # the server reconstructs the g-difference from S_i and Δl
                gi_new = gi[i] + (_sym(Hi_new) - _sym(Hi[i]) + (li_new - li[i]) * eye) @ w[i]
                step_up += FLOAT_BITS + 1  # Δl float + ξ bit
            # server-side aggregate updates
            g = g + (gi_new - gi[i]) / n
            H = H + (Hi_new - Hi[i]) / n
            l_avg = l_avg + (li_new - li[i]) / n
            L[i], Hi[i], li[i], gi[i] = L_new, Hi_new, li_new, gi_new

        up += step_up / n
        down += step_down / n

    return hist


# --------------------------------------------------------------------------
# BL3 — Algorithm 3
# --------------------------------------------------------------------------
def bl3_reference(
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
) -> History:
    """BL3 with the PSD basis of Example 5.1 (both β options)."""
    clients = list(clients)
    n = len(clients)
    d = x0.shape[0]
    tau = n if tau is None else tau
    key = prng.PRNGKey(seed)
    f_star = float(glm.global_loss(clients, x_star))
    Ssum = _psd_sum_matrix(d, x0.dtype, x0.device)

    def h_full(i, x):
        return glm.hess(clients[i], x)

    z = [x0 for _ in range(n)]
    w = [x0 for _ in range(n)]
    zprev = [x0 for _ in range(n)]  # z_i^{k-1} for Option 1
    L = [_psd_h_tilde(h_full(i, x0)) for i in range(n)]
    gam = [max(c, float(L[i].abs().max())) for i in range(n)]
    A_i = [_psd_reconstruct_full(L[i]) + 2.0 * gam[i] * Ssum for i in range(n)]
    C_i = [2.0 * gam[i] * Ssum for i in range(n)]
    beta_i = [float(((_psd_h_tilde(h_full(i, w[i])) + 2 * gam[i]) / (L[i] + 2 * gam[i])).max())
              for i in range(n)]
    beta = max(beta_i)
    g1 = [A_i[i] @ w[i] for i in range(n)]
    g2 = [C_i[i] @ w[i] + glm.grad(clients[i], w[i]) for i in range(n)]
    A_avg = sum(A_i) / n
    C_avg = sum(C_i) / n
    g1_avg = sum(g1) / n
    g2_avg = sum(g2) / n

    up = (d * (d + 1) // 2) * FLOAT_BITS  # ship the L_i^0 coefficients
    down = 0.0
    hist = History([], [], [])

    for _ in range(steps):
        Hk = beta * A_avg - C_avg
        gk = beta * g1_avg - g2_avg
        x_cur = torch.linalg.solve(Hk, gk)
        hist.append(float(glm.global_loss(clients, x_cur)) - f_star, up, down)

        key, sk = prng.split(key)
        # rounds.participation's split-key draw (see bl2 above)
        part = _participants(sk, tau, n)

        step_up = 0.0
        step_down = 0.0
        for i in range(n):
            if not part[i]:
                continue
            key, sk = prng.split(key)
            v_i, vbits = model_comp[i](sk, x_cur - z[i])
            step_down += float(vbits)
            zprev[i] = z[i]
            z[i] = z[i] + eta * v_i

            key, sk = prng.split(key)
            target = _psd_h_tilde(h_full(i, z[i]))
            S, bits = hess_comp[i](sk, target - L[i])
            step_up += float(bits)
            L_new = L[i] + alpha * S
            gam_new = max(c, float(L_new.abs().max()))
            if option == 1:
                num = _psd_h_tilde(h_full(i, zprev[i]))
            else:
                num = target
            beta_new = float(((num + 2 * gam_new) / (L_new + 2 * gam_new)).max())
            A_new = A_i[i] + _psd_reconstruct_full(L_new - L[i]) + 2.0 * (gam_new - gam[i]) * Ssum
            C_new = C_i[i] + 2.0 * (gam_new - gam[i]) * Ssum
            key, sk = prng.split(key)
            xi = 1 if p >= 1.0 else int(prng.bernoulli(sk, p))
            if xi == 1:
                w[i] = z[i]
                g1_new = A_new @ w[i]
                g2_new = C_new @ w[i] + glm.grad(clients[i], w[i])
                step_up += 2 * d * FLOAT_BITS  # the two g-differences
            else:
                g1_new = g1[i] + (A_new - A_i[i]) @ w[i]
                g2_new = g2[i] + (C_new - C_i[i]) @ w[i]
                step_up += 2 * FLOAT_BITS + 1  # β, Δγ floats + ξ bit
            step_up += FLOAT_BITS  # β_i^{k+1} always reaches the server
            A_avg = A_avg + (A_new - A_i[i]) / n
            C_avg = C_avg + (C_new - C_i[i]) / n
            g1_avg = g1_avg + (g1_new - g1[i]) / n
            g2_avg = g2_avg + (g2_new - g2[i]) / n
            L[i], gam[i], A_i[i], C_i[i], g1[i], g2[i] = L_new, gam_new, A_new, C_new, g1_new, g2_new
            beta_i[i] = beta_new

        beta = max(beta_i)
        up += step_up / n
        down += step_down / n

    return hist
