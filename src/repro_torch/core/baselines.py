"""The methods the paper compares against (§6, §A) — port of
`repro.core.baselines`.

Second order: Newton (Table 1's naive and data-basis columns),
NewtonLearn-1 (`nl1`) and FedNL-BAG (`fednl_bag`, the Bernoulli-aggregation
follow-up, on the round engine); FedNL itself is `repro_torch.core.bl.bl1`
with the standard basis and a Rank-R Hessian compressor.  First order: GD
and DIANA on the round engine, and ADIANA, Local-GD and DORE-style
bidirectional compression as the reference's loops, the client loop of
each batched over the fleet.

Conventions are the reference's: ``x0`` and ``x_star`` are (d,) tensors,
every function returns a `bl.History` of per-round gaps and cumulative
per-node uplink and downlink bits, and every entry point takes
``device`` (``None`` means ``"cuda"``, which raises without a GPU).  The
loops' fleets must be homogeneous (one m and λ).  Where the reference
chains keys client after client (``key, sk = split(key)``), the chain is
unrolled on the host and each group of n draws runs as one batched
compressor call; the per-client sums (the server's aggregates, the bits)
are added client by client, in the reference's order.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .. import device as _device
from . import client_batch, comm, glm, prng
from .basis import MatrixBasis
from .bl import _BACKENDS, History, _to, proj_mu, run_fast
from .comm import FLOAT_BITS
from .compressors import Compressor, RandK


def smoothness_constant(clients: Sequence[glm.ClientData]) -> float:
    """L = λ_max(∇²f) upper bound: logistic φ″ ≤ 1/4 ⇒ L ≤ ‖AᵀA‖/(4m) + λ
    (‖A‖ the spectral norm), the largest over the clients."""
    Ls = []
    for c in clients:
        s = torch.linalg.matrix_norm(c.A, ord=2)
        Ls.append(float(s * s) / (4 * c.A.shape[0]) + c.lam)
    return max(Ls)


def _fleet(device, clients, x0, x_star, what: str):
    """The run's inputs on the resolved device, the stacked fleet and f*."""
    dev = _device.resolve(device)
    clients, _, x0, x_star = _to(dev, clients, None, x0, x_star)
    batch = client_batch.from_clients(clients)
    if batch is None:
        raise ValueError(f"{what} needs a homogeneous fleet (one m and λ)")
    return clients, batch, x0, float(client_batch.global_loss(batch, x_star))


def _gap(batch, x, f_star: float) -> float:
    return float(client_batch.global_loss(batch, x)) - f_star


def _client_keys(key: torch.Tensor, n: int):
    """n steps of the reference's chain ``key, sk = split(key)``: the
    advanced key and the (n, 2) subkeys."""
    sks = []
    for _ in range(n):
        key, sk = prng.split(key)
        sks.append(sk)
    return key, torch.stack(sks)


def _bits(comp: Compressor, counts) -> list:
    """Per-client bits of a batched call, as host floats in client order."""
    return comm.price(comp.wire, counts).tolist()


def _mean_in_order(rows: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """``start + rows[0]/n + rows[1]/n + …``, client by client."""
    n = rows.shape[0]
    acc = start
    for i in range(n):
        acc = acc + rows[i] / n
    return acc


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
    "auto" and "fast" run the single-device fast path, "fast+sharded" the
    sharded reducer; bases of another kind raise
    `batched.FastPathUnavailable` under "fast" and `NotImplementedError`
    under "auto"."""
    from . import batched

    def fast(clients, bases, x0, x_star, sharded):
        return batched.newton_fast(clients, x0, x_star, steps, bases=bases,
                                   basis_project=basis_project, sharded=sharded)

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
    _, batch, x0, f_star = _fleet(device, clients, x0, x_star, "nl1")
    n, m, d = batch.n, batch.m, batch.d
    comp = RandK(k=k)
    alpha = 1.0 / (m / min(k, m))
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    key = prng.PRNGKey(seed)
    x = x0
    hcoef = client_batch.hess_weights(batch, x0)           # (n, m), learned φ″
    up = float(m * FLOAT_BITS)                             # ship h⁰ (data known)
    hist = History([], [], [])
    for _ in range(steps):
        hist.append(_gap(batch, x, f_star), up, 0.0)
        g = client_batch.global_grad(batch, x)
        H = (torch.einsum("nmd,nm,nme->nde", batch.A, hcoef, batch.A) / m).sum(dim=0) / n
        x = x - torch.linalg.solve(proj_mu(H + batch.lam * eye, batch.lam), g)
        key, sks = _client_keys(key, n)
        S, counts = comp.compress(sks, client_batch.hess_weights(batch, x) - hcoef)
        hcoef = hcoef + alpha * S
        step_bits = 0.0
        for b in _bits(comp, counts):
            step_bits += b
        up += step_bits / n + d * FLOAT_BITS               # gradients every step
    return hist


def fednl_bag(
    clients: Sequence[glm.ClientData],
    bases: Sequence[MatrixBasis],
    hess_comp: Sequence[Compressor],
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    alpha: float = 1.0,
    q: float = 0.5,
    eta: Optional[float] = None,
    mu: Optional[float] = None,
    seed: int = 0,
    init_exact_hessian: bool = True,
    backend: str = "auto",
    exact: bool = True,
    *,
    device=None,
) -> History:
    """FedNL with Bernoulli-lazy gradient aggregation (`specs.FedNLBAGSpec`
    on the round engine).  Args are the reference's
    (`repro.core.baselines.fednl_bag`), plus ``device``.  Spec-only, as in
    the reference: ``backend="reference"`` raises `ValueError`.  ``exact``
    selects the "fast+sharded" reducer's collectives (the bitwise gather,
    or the spec's `rounds.ReducePlan`); ignored off that backend."""
    from . import batched

    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if backend == "reference":
        raise ValueError("fednl_bag is spec-only; no reference backend")

    def fast(clients, bases, x0, x_star, sharded):
        try:
            return batched.fednl_bag_fast(
                clients, bases, hess_comp, x0, x_star, steps, alpha=alpha, q=q,
                eta=eta, mu=mu, seed=seed, init_exact_hessian=init_exact_hessian,
                sharded=sharded, exact=exact)
        except batched.FastPathUnavailable as e:
            raise ValueError(f"fednl_bag requires a stackable homogeneous fleet ({e})") from e

    return run_fast(backend, device, clients, bases, x0, x_star, fast)


# ==========================================================================
# First-order methods
# ==========================================================================
def gd(clients, x0, x_star, steps, lr: Optional[float] = None,
       backend: str = "auto", *, device=None) -> History:
    """Distributed gradient descent (`specs.GDSpec` on the round engine),
    d floats a client a round; ``lr`` defaults to 1/L
    (`smoothness_constant`).  The downlink is an exact broadcast, not
    billed."""
    from . import batched

    def fast(clients, _bases, x0, x_star, sharded):
        return batched.gd_fast(clients, x0, x_star, steps, lr=lr, sharded=sharded)

    return run_fast(backend, device, clients, None, x0, x_star, fast)


def diana(clients, x0, x_star, steps, comp: Compressor, omega: float,
          lr: Optional[float] = None, seed: int = 0, backend: str = "auto",
          *, device=None) -> History:
    """DIANA [Mishchenko et al. 2019] (`specs.DianaSpec` on the round
    engine): compressed gradient differences with shifts hᵢ, α_h =
    1/(ω+1), ``lr`` by default the theoretical min(α_h/2μ,
    1/(L(1+6ω/n))); ``comp`` is unbiased (e.g. `RandomDithering`) with
    variance ω, and every round's client keys are ``split(round_key, n)``
    as in the reference's fast path."""
    from . import batched

    def fast(clients, _bases, x0, x_star, sharded):
        return batched.diana_fast(clients, x0, x_star, steps, comp, omega, lr=lr, seed=seed,
                                  sharded=sharded)

    return run_fast(backend, device, clients, None, x0, x_star, fast)


def adiana(clients, x0, x_star, steps, comp: Compressor, omega: float,
           seed: int = 0, *, device=None) -> History:
    """ADIANA [Li et al. 2020, Alg. 1] with the reference's theoretical
    parameters (strongly convex case): each round bills two compressed
    messages a client (the xᵏ and wᵏ shift differences).  The reference
    has only its loop; its key chain is unrolled on the host, n splits
    for the xᵏ messages, n for the wᵏ messages and one for the Bernoulli
    draw of wᵏ⁺¹, and each group of n runs as one batched compressor call."""
    clients, batch, x0, f_star = _fleet(device, clients, x0, x_star, "adiana")
    n, d = batch.n, batch.d
    L = smoothness_constant(clients)
    mu = batch.lam
    key = prng.PRNGKey(seed)

    alpha_h = 1.0 / (omega + 1.0)
    eta = 1.0 / (2.0 * L) if omega == 0 else min(1.0 / (2.0 * L), n / (64.0 * omega * L))
    theta1 = min(1.0 / 4.0, math.sqrt(eta * mu / 4.0))
    theta2 = 0.5
    gamma = eta / (2.0 * (theta1 + theta2 * eta * mu))
    beta = 1.0 - gamma * mu

    x = y = zv = wv = x0
    h = torch.zeros((n, d), dtype=x0.dtype, device=x0.device)
    h_avg = torch.zeros(d, dtype=x0.dtype, device=x0.device)
    up = 0.0
    hist = History([], [], [])
    for _ in range(steps):
        hist.append(_gap(batch, y, f_star), up, 0.0)
        xk = theta1 * zv + theta2 * wv + (1 - theta1 - theta2) * y
        key, sks = _client_keys(key, n)
        q, counts = comp.compress(sks, client_batch.grads(batch, xk) - h)
        ghat = _mean_in_order(q, h_avg)
        step_bits = 0.0
        for b in _bits(comp, counts):
            step_bits += b
        # shifts toward ∇fᵢ(wᵏ)
        key, sks = _client_keys(key, n)
        qw, counts = comp.compress(sks, client_batch.grads(batch, wv) - h)
        h_avg = _mean_in_order(alpha_h * qw, h_avg)
        h = h + alpha_h * qw
        for b in _bits(comp, counts):
            step_bits += b
        y_next = xk - eta * ghat
        zv = beta * zv + (1 - beta) * xk + (gamma / eta) * (y_next - xk)
        key, sk = prng.split(key)
        if bool(prng.bernoulli(sk, theta2)):
            wv = y
        y = y_next
        up += step_bits / n
    return hist


def local_gd(clients, x0, x_star, steps, local_steps: int = 5,
             lr: Optional[float] = None, *, device=None) -> History:
    """Local GD (S-Local-GD's deterministic-sync special case): every
    client takes `local_steps` gradient steps from the shared iterate at
    its own iterate, the fleet batched, then the server averages them; one
    d-float uplink a client a round; ``lr`` defaults to 1/L."""
    clients, batch, x0, f_star = _fleet(device, clients, x0, x_star, "local_gd")
    n, d = batch.n, batch.d
    lr = 1.0 / smoothness_constant(clients) if lr is None else lr
    x = x0
    up = 0.0
    hist = History([], [], [])
    for _ in range(steps):
        hist.append(_gap(batch, x, f_star), up, 0.0)
        xi = x.expand(n, d)
        for _ in range(local_steps):
            xi = xi - lr * client_batch.grads(batch, xi)
        acc = xi[0]
        for i in range(1, n):
            acc = acc + xi[i]
        x = acc / n
        up += d * FLOAT_BITS
    return hist


def dore_like(clients, x0, x_star, steps, up_comp: Compressor, down_comp: Compressor,
              lr: Optional[float] = None, seed: int = 0, *, device=None) -> History:
    """DORE-style bidirectionally compressed GD with error feedback both
    ways: the fleet's uplink (gradient plus its error) is one batched
    compressor call a round, the model delta's downlink one single-client
    call; ``lr`` defaults to 0.5/L; the downlink is billed.  The
    reference's key chain (n client keys, then one downlink key, a round)
    is kept even for compressors that draw nothing."""
    clients, batch, x0, f_star = _fleet(device, clients, x0, x_star, "dore_like")
    n, d = batch.n, batch.d
    lr = 0.5 / smoothness_constant(clients) if lr is None else lr
    key = prng.PRNGKey(seed)
    x = x_dev = x0
    err_up = torch.zeros((n, d), dtype=x0.dtype, device=x0.device)
    err_down = torch.zeros(d, dtype=x0.dtype, device=x0.device)
    up = down = 0.0
    hist = History([], [], [])
    for _ in range(steps):
        hist.append(_gap(batch, x, f_star), up, down)
        key, sks = _client_keys(key, n)
        gi = client_batch.grads(batch, x_dev) + err_up
        q, counts = up_comp.compress(None if up_comp.deterministic else sks, gi)
        err_up = gi - q
        agg = _mean_in_order(q, torch.zeros(d, dtype=x0.dtype, device=x0.device))
        sb = 0.0
        for b in _bits(up_comp, counts):
            sb += b
        up += sb / n
        x = x - lr * agg
        key, sk = prng.split(key)
        delta = x - x_dev + err_down
        qd, dbits = down_comp(None if down_comp.deterministic else sk, delta)
        err_down = delta - qd
        down += float(dbits)
        x_dev = x_dev + qd
    return hist
