"""Declarative method specs for the round engine — port of
`repro.core.specs` (the `MethodSpec` hooks and `BL1Spec`).

A spec is a frozen dataclass holding a method's hyperparameters and the
hooks `rounds.run_rounds` calls:

  * ``prepare(R, batch, basisb, x0)`` — per-run precomputation (a
    `rounds.CoeffLayout`);
  * ``init(R, env)``                 — the carry at round 0;
  * ``step(R, env, carry, rc)``      — one round, returning
    ``(carry, (eval_x, ledger))``: the iterate the round is evaluated at
    and the cumulative `comm.CommLedger` at the round's start;
  * ``eval_streams(batch, xs_t, f_star)`` — the post-loop evaluation.

BL2, BL3, FedNL-BAG and the baselines come with ROADMAP.md §1 item 10.
"""
from __future__ import annotations

import dataclasses

import torch

from . import client_batch, comm
from .bl import proj_mu
from .comm import CommLedger
from .compressors import Compressor
from .rounds import coeff_layout, default_gap_stream, global_grad, shift_update, xi_scalar


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
