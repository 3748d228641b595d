"""Batched execution engine — the configuration layer of the fast path;
port of `repro.core.batched` for BL1, BL2, BL3 and Newton.

Per-client state lives in leading-axis-`n` stacked tensors (`ClientBatch`,
`BatchedBasis`); this module validates and stacks the fleet, builds the
frozen method spec (`specs.BL1Spec`, `BL2Spec`, `BL3Spec`, `NewtonSpec`),
runs it on `rounds.run_rounds` with the run's seed, and turns the streams
into a `History`.  Raises
`FastPathUnavailable` for fleets the stacked representation cannot
express (heterogeneous shapes, mixed basis kinds, mixed or unported
compressors).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import client_batch, comm, rounds, specs
from .bl import History
from .comm import FLOAT_BITS
from .compressors import (ComposedRankR, ComposedTopK, Compressor, Identity,
                          NaturalCompression, RandK, RandomDithering, RankR, TopK)


class FastPathUnavailable(Exception):
    """This configuration cannot run batched; use the reference backend."""


_SUPPORTED = (Identity, TopK, RandK, RankR, RandomDithering, NaturalCompression,
              ComposedTopK, ComposedRankR)


def _check_supported(comp: Compressor) -> None:
    if type(comp) not in _SUPPORTED:
        raise FastPathUnavailable(f"unsupported compressor {type(comp).__name__}")
    for inner in ("inner", "inner_u", "inner_v"):
        if hasattr(comp, inner):
            _check_supported(getattr(comp, inner))


def _one_of(comps: Sequence[Compressor], what: str) -> Compressor:
    """The fleet's single compressor config; raise if heterogeneous."""
    c0 = comps[0]
    _check_supported(c0)
    for c in comps[1:]:
        if type(c) is not type(c0) or c != c0:
            raise FastPathUnavailable(f"heterogeneous {what} compressors")
    return c0


def _stack_or_raise(clients, bases=None, basis_project="einsum"):
    if basis_project not in client_batch.PROJECT_ROUTES:
        raise ValueError(f"basis_project must be one of {client_batch.PROJECT_ROUTES}, "
                         f"got {basis_project!r}")
    batch = client_batch.from_clients(clients)
    if batch is None:
        raise FastPathUnavailable("heterogeneous client shapes / λ")
    basisb = None
    if bases is not None:
        basisb = client_batch.stack_bases(bases, basis_project)
        if basisb is None:
            raise FastPathUnavailable("mixed basis kinds")
    return batch, basisb


def _history(evals, leds: comm.CommLedger) -> History:
    """History from (eval streams, per-leg ledger streams): `up_bits` is the
    ledger's uplink total (hess + grad + basis shipment)."""
    def host(x):
        return list(map(float, x.detach().cpu().numpy()))

    g = np.maximum(evals["gap"].detach().cpu().numpy(), 0.0)
    legs = {name: host(getattr(leds, name)) for name in comm.CommLedger.LEGS}
    metrics = {k: host(v) for k, v in evals.items() if k != "gap"} or None
    return History(list(map(float, g)), host(leds.uplink), host(leds.model_down),
                   legs=legs, metrics=metrics)


def _f_star(batch, x_star) -> torch.Tensor:
    return client_batch.global_loss(batch, x_star)


def _block_mode(basisb, comp) -> bool:
    """True when coefficient state can live in compact (n, r, r) blocks: the
    data basis with a flat Top-K, plain or composed, keeping K ≤ r² (its
    output and bits are invariant to dropping the padding zeros)."""
    if basisb is None or basisb.kind != "data_outer":
        return False
    rb = basisb.r_max
    if type(comp) is TopK and not comp.symmetrize and comp.k <= rb * rb:
        return True
    return type(comp) is ComposedTopK and comp.k <= rb * rb


def _run(spec, batch, basisb, x0, x_star, steps, seed=0, *, stream=None) -> History:
    evals, leds = rounds.run_rounds(spec, batch, basisb, x0, _f_star(batch, x_star),
                                    steps, seed=seed, stream=stream)
    return _history(evals, leds)


# ==========================================================================
# BL1 — Algorithm 1 (fast path)
# ==========================================================================
def bl1_setup(clients, bases, hess_comp, model_comp, alpha=1.0, eta=1.0,
              p=1.0, mu=None, init_exact_hessian=True, basis_project="einsum"):
    batch, basisb = _stack_or_raise(clients, bases, basis_project)
    hc = _one_of(list(hess_comp), "hessian")
    _check_supported(model_comp)
    spec = specs.BL1Spec(
        hess_comp=hc, model_comp=model_comp, alpha=alpha, eta=eta, p=p,
        mu=batch.lam if mu is None else mu, init_exact=init_exact_hessian,
        grad_bits=basisb.grad_uplink_bits_mean(),
        init_hess_bits=basisb.init_coeff_bits_mean(init_exact_hessian),
        basis_bits=basisb.transmission_bits_mean(),
        block=_block_mode(basisb, hc),
    )
    return spec, batch, basisb


def bl1_fast(clients, bases, hess_comp, model_comp, x0, x_star, steps,
             alpha=1.0, eta=1.0, p=1.0, mu=None, seed=0,
             init_exact_hessian=True, stream=None, basis_project="einsum") -> History:
    """BL1 on the stacked single-device engine."""
    spec, batch, basisb = bl1_setup(
        clients, bases, hess_comp, model_comp, alpha=alpha, eta=eta, p=p,
        mu=mu, init_exact_hessian=init_exact_hessian, basis_project=basis_project)
    return _run(spec, batch, basisb, x0, x_star, steps, seed, stream=stream)


# ==========================================================================
# BL2 — Algorithm 2 (fast path)
# ==========================================================================
def bl2_setup(clients, bases, hess_comp, model_comp, alpha=1.0, eta=1.0,
              p=1.0, tau=None, init_exact_hessian=True):
    batch, basisb = _stack_or_raise(clients, bases)
    hc = _one_of(list(hess_comp), "hessian")
    mc = _one_of(list(model_comp), "model")
    spec = specs.BL2Spec(
        hess_comp=hc, model_comp=mc, alpha=alpha, eta=eta, p=p,
        tau=batch.n if tau is None else tau, init_exact=init_exact_hessian,
        init_hess_bits=basisb.init_coeff_bits_mean(init_exact_hessian),
        basis_bits=basisb.transmission_bits_mean(),
        block=_block_mode(basisb, hc),
    )
    return spec, batch, basisb


def bl2_fast(clients, bases, hess_comp, model_comp, x0, x_star, steps,
             alpha=1.0, eta=1.0, p=1.0, tau=None, seed=0,
             init_exact_hessian=True, stream=None) -> History:
    """BL2 on the stacked single-device engine."""
    spec, batch, basisb = bl2_setup(
        clients, bases, hess_comp, model_comp, alpha=alpha, eta=eta, p=p,
        tau=tau, init_exact_hessian=init_exact_hessian)
    return _run(spec, batch, basisb, x0, x_star, steps, seed, stream=stream)


# ==========================================================================
# BL3 — Algorithm 3 (fast path, PSD basis of Example 5.1)
# ==========================================================================
def bl3_setup(clients, hess_comp, model_comp, alpha=1.0, eta=1.0, p=1.0,
              tau=None, c=1e-8, option=2):
    batch, _ = _stack_or_raise(clients)
    hc = _one_of(list(hess_comp), "hessian")
    mc = _one_of(list(model_comp), "model")
    spec = specs.BL3Spec(
        hess_comp=hc, model_comp=mc, alpha=alpha, eta=eta, p=p,
        tau=batch.n if tau is None else tau, c=c, option=option,
    )
    return spec, batch, None


def bl3_fast(clients, hess_comp, model_comp, x0, x_star, steps, alpha=1.0,
             eta=1.0, p=1.0, tau=None, c=1e-8, option=2, seed=0,
             stream=None) -> History:
    """BL3 on the stacked single-device engine."""
    spec, batch, basisb = bl3_setup(
        clients, hess_comp, model_comp, alpha=alpha, eta=eta, p=p, tau=tau,
        c=c, option=option)
    return _run(spec, batch, basisb, x0, x_star, steps, seed, stream=stream)


# ==========================================================================
# Newton (fast path)
# ==========================================================================
def newton_fast(clients, x0, x_star, steps, bases=None,
                basis_project="einsum") -> History:
    """Newton on the stacked single-device engine: d² + d floats a round
    without a basis, r² + r with the data basis (plus its one-time dr
    shipment)."""
    batch, basisb = _stack_or_raise(clients, bases, basis_project)
    d = batch.d
    if basisb is None:
        basis_bits = 0.0
        hess_bits = d * d * FLOAT_BITS
        grad_bits = d * FLOAT_BITS
    else:
        if basisb.kind != "data_outer":
            raise FastPathUnavailable("newton basis path expects DataOuterBasis")
        rs = basisb.rs
        basis_bits = sum(d * r * FLOAT_BITS for r in rs) / len(rs)
        hess_bits = sum(r * r for r in rs) / len(rs) * FLOAT_BITS
        grad_bits = sum(float(r) for r in rs) / len(rs) * FLOAT_BITS
    spec = specs.NewtonSpec(hess_bits=hess_bits, grad_bits=grad_bits,
                            basis_bits=basis_bits)
    return _run(spec, batch, basisb, x0, x_star, steps)
