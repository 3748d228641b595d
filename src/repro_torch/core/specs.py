"""Declarative method specs for the round engine — port of
`repro.core.specs` (the `MethodSpec` hooks, `BL1Spec`, `NewtonSpec` and
`BLDNNSpec`).

A spec is a frozen dataclass holding a method's hyperparameters and the
hooks `rounds.run_rounds` calls:

  * ``prepare(R, batch, basisb, x0)`` — per-run precomputation (a
    `rounds.CoeffLayout`);
  * ``init(R, env)``                 — the carry at round 0;
  * ``step(R, env, carry, rc)``      — one round, returning
    ``(carry, (eval_x, ledger))``: the iterate the round is evaluated at
    and the cumulative `comm.CommLedger` at the round's start;
  * ``eval_streams(batch, xs_t, f_star)`` — the post-loop evaluation.

BL2, BL3, FedNL-BAG and the other baselines come with ROADMAP.md §1
item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import client_batch, comm
from .bl import proj_mu
from .comm import CommLedger
from .compressors import Compressor
from .pytree import tree_leaves, tree_map
from .rounds import (coeff_layout, default_gap_stream, global_grad, refresh_due,
                     shift_update, tree_shift_update, tree_shift_update_sum, xi_scalar)


class MethodSpec:
    """Base hooks; subclasses are frozen dataclasses."""

    def prepare(self, R, batch, basisb, x0):
        return None

    def init(self, R, env):
        raise NotImplementedError

    def step(self, R, env, carry, rc):
        raise NotImplementedError

    def eval_streams(self, batch, xs_t, f_star):
        """Named (steps,) streams from the trajectory, always holding
        ``"gap"``: the GLM optimality gap f(x_t) − f*."""
        return {"gap": default_gap_stream(batch, xs_t, f_star)}


# ==========================================================================
# BL1 — Algorithm 1
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class BL1Spec(MethodSpec):
    hess_comp: Compressor
    model_comp: Compressor
    alpha: float
    eta: float
    p: float
    mu: float
    init_exact: bool
    grad_bits: float
    init_hess_bits: float
    basis_bits: float
    block: bool

    def prepare(self, R, batch, basisb, x0):
        return coeff_layout(R, batch, basisb, x0, self.block)

    def init(self, R, env):
        lay = env.extra
        x0 = env.x0
        L0 = (lay.target_at(x0) if self.init_exact
              else torch.zeros(lay.shape, dtype=x0.dtype, device=x0.device))
        H0 = R.mean(lay.recon(L0)) + lay.ridge
        grad_w0 = global_grad(R, env.batch, x0)
        led0 = CommLedger.create(hess_up=self.init_hess_bits,
                                 basis_ship=self.basis_bits, device=x0.device)
        return (x0, x0, L0, H0, grad_w0, torch.tensor(True, device=x0.device), led0)

    def step(self, R, env, carry, rc):
        z, w, L, H, grad_w, xi, led = carry
        lay = env.extra
        ys = (z, led)  # gap evaluated at z, after the loop

        # client-side legs: gradients + Hessian-coefficient learning, then
        # one uplink reduction for the round
        S, L_n, counts = shift_update(
            lambda delta: self.hess_comp.compress(None, delta),
            lay.target_at(z), L, self.alpha)
        red = R.reduce_tree(
            {"grad_z": client_batch.grads(env.batch, z),
             "dH": lay.recon(self.alpha * S),
             "sbits": comm.price(self.hess_comp.wire, counts)})
        grad_z = red["grad_z"]
        H_n = H + red["dH"]
        led = led.add(grad_up=xi.to(torch.float64) * self.grad_bits,
                      hess_up=red["sbits"])

        # gradient leg (both branches evaluated, selected by ξ)
        w_n = torch.where(xi, z, w)
        grad_w_n = torch.where(xi, grad_z, grad_w)

        # server model step (μ-projection + Newton solve, once per fleet) +
        # compressed broadcast
        def server_step(H, grad_z, z, w, grad_w, xi):
            Hmu = proj_mu(H, self.mu)
            g = torch.where(xi, grad_z, Hmu @ (z - w) + grad_w)
            return z - torch.linalg.solve(Hmu, g)

        x_next = R.once(server_step, H, grad_z, z, w, grad_w, xi)
        v, vbits = self.model_comp(None, x_next - z)
        led = led.add(model_down=vbits)
        z_n = z + self.eta * v
        xi_n = xi_scalar(self.p, device=z.device)
        return (z_n, w_n, L_n, H_n, grad_w_n, xi_n, led), ys


# ==========================================================================
# Newton — Table 1's naive (§2.1) and data-basis (§2.3) columns
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class NewtonSpec(MethodSpec):
    """Classical Newton: every client sends its Hessian (or, with the data
    basis, its r×r coefficients Γᵢ) and its gradient every round; the
    server solves with their fleet means.  Bits per round are fixed."""

    hess_bits: float
    grad_bits: float
    basis_bits: float

    def init(self, R, env):
        return (env.x0, CommLedger.create(basis_ship=self.basis_bits, device=env.x0.device))

    def step(self, R, env, carry, rc):
        x, led = carry
        batch = env.batch
        if env.basisb is None:
            Hc = client_batch.hess(batch, x)
        else:
            coef = client_batch.hess_coeff_target(env.basisb, batch, x)
            Hc = env.basisb.server_reconstruct(coef, batch.lam)
        red = R.reduce_tree({"H": Hc, "g": client_batch.grads(batch, x)})
        x_n = R.once(lambda H, g: x - torch.linalg.solve(H, g), red["H"], red["g"])
        return (x_n, led.add(hess_up=self.hess_bits, grad_up=self.grad_bits)), (x, led)


# ==========================================================================
# BL-DNN — the paper's communication layer on parameter pytrees
# (public entry point: repro_torch.fed.bldnn.run_bldnn)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class BasisRefreshPolicy:
    """Amortized basis shipment.  ``rounds_per_refresh = 0`` ships once
    (billed at round 0).  ``T ≥ 1`` re-bills the shipment at every later
    boundary ``t % T == 0`` when the previous round's fleet-mean
    rotated-coefficient energy leakage (1 − ‖C(Δ)‖²/‖Δ‖² on the gradient
    leg) has reached ``drift_threshold``.  Accounting only: the basis
    itself never changes, so trajectories do not depend on the policy."""

    rounds_per_refresh: int = 0
    drift_threshold: float = 0.0

    @property
    def amortized(self) -> bool:
        return self.rounds_per_refresh > 0

    def __post_init__(self):
        if self.rounds_per_refresh < 0:
            raise ValueError("rounds_per_refresh must be >= 0 "
                             f"(0 = ship once), got {self.rounds_per_refresh}")
        if self.drift_threshold < 0.0:
            raise ValueError(f"drift_threshold must be >= 0, got {self.drift_threshold}")


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-client squared norm of a client-stacked leaf, in float64."""
    return x.to(torch.float64).square().sum(dim=tuple(range(1, x.dim())))


@dataclasses.dataclass(frozen=True)
class BLDNNSpec(MethodSpec):
    """Basis Learn + compressed-shift learning applied per layer of a DNN.

    Every array is a parameter pytree (leaves carry the leading client
    axis):

      1. per-client gradients, rotated into the pytree basis (`env.basisb`;
         None is the standard basis), go through the Alg. 1 shift
         recursion with one compressor per leaf, billed on ``grad_up``;
      2. the Fisher diagonal g² (standard basis) goes through the same
         recursion with the fused compress-sum codec, billed on
         ``hess_up``; the server preconditions with it;
      3. the server step x ← x − lr·ĝ/(√F̂+ε) on the shared parameters.

    Every leg is priced at the f32 wire; the basis shipment bills on
    ``basis_ship`` at round 0 (and on the `BasisRefreshPolicy` schedule).
    ``loss_fn(params, client_data)`` is the per-client loss,
    ``eval_fn(params, data) -> {"gap", "loss"}`` the post-loop evaluation.
    """

    loss_fn: Callable
    eval_fn: Callable
    grad_comps: Tuple[Compressor, ...]
    fisher_comps: Tuple[Compressor, ...]
    alpha: float = 1.0            # shift learning rate (contractive ⇒ 1)
    fisher_alpha: float = 0.1
    lr: float = 1e-3
    eps: float = 1e-2
    precondition: bool = True
    #: bits of one basis shipment; None prices ``ship_floats() × 32``
    basis_ship_bits: Optional[float] = None
    refresh: BasisRefreshPolicy = BasisRefreshPolicy()

    WIRE_FLOAT_BITS = 32          # DNN tensors are f32 on the wire

    def _bill(self, comps, auxs):
        """Per-client bits: per-leaf counts priced at the f32 wire, summed
        over leaves."""
        return sum(comm.price(comm.with_float_bits(c.wire, self.WIRE_FLOAT_BITS), a)
                   for c, a in zip(comps, auxs))

    def _ship_bits(self, env) -> float:
        if env.basisb is None:
            return 0.0
        if self.basis_ship_bits is not None:
            return float(self.basis_ship_bits)
        return env.basisb.ship_floats() * self.WIRE_FLOAT_BITS

    def init(self, R, env):
        params = env.x0
        dev = tree_leaves(params)[0].device

        def stacked(p):
            return torch.zeros((R.n_local,) + tuple(p.shape), dtype=torch.float32, device=dev)

        shift = tree_map(stacked, params)
        fshift = tree_map(stacked, params)
        server_f = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
                            params)
        led0 = CommLedger.create(basis_ship=self._ship_bits(env), device=dev)
        carry = (params, shift, fshift, server_f, led0)
        if self.refresh.amortized:
            # last round's fleet-mean energy leakage, the drift trigger's input
            carry = carry + (torch.zeros((), dtype=torch.float64, device=dev),)
        return carry

    def step(self, R, env, carry, rc):
        amortized = self.refresh.amortized
        if amortized:
            params, shift, fshift, server_f, led, drift = carry
        else:
            params, shift, fshift, server_f, led = carry
        ys = (params, led)  # evaluated after the loop
        basis = env.basisb

        # per-client gradients, rotated into the per-layer basis
        g = torch.func.vmap(torch.func.grad(self.loss_fn), in_dims=(None, 0))(
            params, env.batch.data)
        coeff = g if basis is None else basis.rotate(g)
        S, shift_n, gauxs = tree_shift_update(
            lambda i, delta: self.grad_comps[i].compress(None, delta),
            coeff, shift, self.alpha)
        gbits = self._bill(self.grad_comps, gauxs)

        if self.precondition:
            # the second-order leg: the Fisher diagonal g² through the same
            # recursion, with the fused compress-then-sum codec
            ftarget = tree_map(lambda gi: gi.to(torch.float32).square(), g)
            Fc, fshift_n, fauxs, fsums = tree_shift_update_sum(
                lambda i, delta: self.fisher_comps[i].compress_sum(None, delta),
                ftarget, fshift, self.fisher_alpha)
            fbits = self._bill(self.fisher_comps, fauxs)
        else:
            fshift_n = fshift
            fbits = torch.zeros((R.n_local,), dtype=torch.float64,
                                device=tree_leaves(shift)[0].device)

        # one uplink reduction for the round: the server mirrors every
        # client's recursion, so its gradient estimate is the fleet mean of
        # the updated shifts
        agg = {"coeff": shift_n, "gbits": gbits, "fbits": fbits}
        if amortized:
            kept = sum(_sq_norms(s) for s in tree_leaves(S))
            total = sum(_sq_norms(c - s0)
                        for c, s0 in zip(tree_leaves(coeff), tree_leaves(shift)))
            safe = torch.where(total > 0.0, total, torch.ones_like(total))
            agg["drift"] = torch.clamp(
                torch.where(total > 0.0, 1.0 - kept / safe, torch.zeros_like(total)), min=0.0)
        red = R.reduce_tree(agg)
        g_hat = red["coeff"] if basis is None else basis.unrotate(red["coeff"])

        if self.precondition:
            fmeans = R.tree_mean_presummed(Fc, fsums)
            server_f_n = tree_map(lambda sf, fm: sf + self.fisher_alpha * fm, server_f, fmeans)
            update = tree_map(
                lambda gh, sf: gh / (torch.sqrt(torch.clamp(sf, min=0.0)) + self.eps),
                g_hat, server_f_n)
        else:
            server_f_n, update = server_f, g_hat

        params_n = tree_map(lambda p, u: (p.to(torch.float32) - self.lr * u).to(p.dtype),
                            params, update)
        if amortized:
            # re-ship at refresh boundaries when last round's drift reached
            # the trigger; round 0's shipment is billed by init
            ship = 0.0
            if refresh_due(rc.t, self.refresh.rounds_per_refresh) and rc.t > 0:
                bits = torch.tensor(self._ship_bits(env), dtype=torch.float64,
                                    device=drift.device)
                ship = torch.where(drift >= self.refresh.drift_threshold, bits,
                                   torch.zeros_like(bits))
            led = led.add(grad_up=red["gbits"], hess_up=red["fbits"], basis_ship=ship)
            return (params_n, shift_n, fshift_n, server_f_n, led, red["drift"]), ys
        led = led.add(grad_up=red["gbits"], hess_up=red["fbits"])
        return (params_n, shift_n, fshift_n, server_f_n, led), ys

    def eval_streams(self, batch, xs_t, f_star):
        """`eval_fn` at every round's parameters (``xs_t`` stacked leaf by
        leaf), as named (steps,) streams; ``f_star`` is unused — the gap
        stream is the training error rate."""
        steps = tree_leaves(xs_t)[0].shape[0]
        per_round = [self.eval_fn(tree_map(lambda a: a[t], xs_t), batch.data)
                     for t in range(steps)]
        return {name: torch.stack([ev[name] for ev in per_round]) for name in per_round[0]}
