"""Declarative method specs for the round engine — port of
`repro.core.specs` (the `MethodSpec` hooks, `BL1Spec`, `BL2Spec`,
`BL3Spec`, `GDSpec`, `DianaSpec`, `NewtonSpec`, `FedNLBAGSpec` and
`BLDNNSpec`).

A spec is a frozen dataclass holding a method's hyperparameters and the
hooks `rounds.run_rounds` calls:

  * ``prepare(R, batch, basisb, x0)`` — per-run precomputation (a
    `rounds.CoeffLayout`);
  * ``init(R, env)``                 — the carry at round 0;
  * ``step(R, env, carry, rc)``      — one round, returning
    ``(carry, (eval_x, ledger, event))``: the iterate the round is
    evaluated at, the cumulative `comm.CommLedger` at the round's start
    and the round's `rounds.EVENT_*` bits (an int32 tensor from
    `rounds.participation`, else ``EVENT_NONE``);
  * ``eval_streams(batch, xs_t, f_star)`` — the post-loop evaluation.

A round's keys are split from ``rc.key`` as the reference splits them, on
the host; a spec whose compressors all draw nothing (and, for BL1, p = 1)
splits none, which changes no bit.

The cohort contract (`MethodSpec.supports_cohort`, `carry_names`,
`cohort_aggregates`, `cohort_init_extras`, `cohort_server_init`) lets
`BL2Spec`, `BL3Spec` and `FedNLBAGSpec` run under the cohort-streaming
engine (`repro_torch.core.cohort`): every fleet reduction of their step is
a named `reduce_tree` entry, so the engine can hand the absent clients'
frozen contributions in, and each round's upload mask (participants, or
BAG's reporters) is recorded with `rounds.note_uploads`.  The same three
specs read the fault layer's availability mask (`RoundCtx.avail`,
`MethodSpec.supports_faults`): an unavailable client neither participates
nor reports, and the round's events say so.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import client_batch, comm, prng
from .bl import _psd_h_tilde, _psd_reconstruct_full, _psd_sum_matrix, proj_mu
from .comm import FLOAT_BITS, CommLedger
from .compressors import Compressor
from .pytree import tree_leaves, tree_map
from .rounds import (EVENT_ALL_DOWN, EVENT_DEGRADED, EVENT_NONE, client_keys_for, coeff_layout,
                     default_gap_stream, downlink_broadcast, global_grad, note_uploads,
                     participation, refresh_due, shift_update, tree_shift_update,
                     tree_shift_update_sum, xi_mask, xi_scalar)


def _sym_b(H: torch.Tensor) -> torch.Tensor:
    """(n, d, d) batched symmetrization."""
    return (H + H.mT) / 2.0


def _fro_b(H: torch.Tensor) -> torch.Tensor:
    """(n, d, d) → (n,) Frobenius norms."""
    return torch.sqrt((H * H).sum(dim=(1, 2)))


def _bill_fleet(R, led: CommLedger, bits: dict, down: torch.Tensor) -> CommLedger:
    """A partial-participation round's bill: the participants' fleet bit
    sums (Hessian leg, gradient leg, model downlink), moved to the host in
    one copy and added to the host ledger per node."""
    s, g, dn = torch.stack([bits["s"], bits["g"], down]).tolist()
    return led.add_fleet_sums(R.n_total, hess_up=s, grad_up=g, model_down=dn)


def _round_keys(key: torch.Tensor, num: int, draws: bool):
    """``split(key, num)`` as a tuple of keys when the round draws, else
    ``num`` Nones."""
    return tuple(prng.split(key, num)) if draws else (None,) * num


class MethodSpec:
    """Base hooks; subclasses are frozen dataclasses."""

    #: True for specs whose round reacts to the fault layer's availability
    #: mask (`RoundCtx.avail`): the partial-participation methods (BL2/BL3)
    #: and the Bernoulli-lazy uplink (FedNL-BAG).  `repro_torch.launch.fed_serve`
    #: refuses to inject faults into any other spec rather than ignore them
    supports_faults = False

    #: True for specs whose `step` runs under the cohort-streaming engine
    #: (`repro_torch.core.cohort`): every fleet reduction goes through a
    #: named `reduce_tree` entry declared in `cohort_aggregates`, so the
    #: engine can supply the absent clients' frozen contributions
    supports_cohort = False

    #: names of the top-level carry elements, in order: the streaming
    #: engine's handle for splitting the carry into host-resident client
    #: state (`client_batch.ClientStore.state`) and server state
    carry_names: Tuple[str, ...] = ()

    def cohort_aggregates(self):
        """Fleet aggregates `step` reduces over raw carry leaves:
        ``{aggregate: (carry_leaf, op)}`` with op "mean" or "max".  The
        engine keeps each mean leaf's fleet sum and hands the chunk
        ``frozen[aggregate]``, the absent clients' sum (or, for "max",
        their max).  Delta-style means (absent clients add exactly 0) are
        not declared: a missing frozen entry is a zero."""
        return {}

    def cohort_init_extras(self, R, env, carry):
        """Per-client stacked tensors whose fleet sum feeds a server
        element of the init carry (``{name: (n, ...) tensor}``), summed by
        the engine over its init slabs."""
        return {}

    def cohort_server_init(self, env, sums, n_total: int, carry):
        """Server carry elements that need a fleet reduction at init,
        ``{carry_name: value}``, from the slabs' `cohort_init_extras`
        sums; every other server element keeps its first slab's value."""
        return {}

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
        ys = (z, led, EVENT_NONE)  # gap evaluated at z, after the loop
        draws = self.p < 1.0 or self.hess_comp.stochastic or self.model_comp.stochastic
        k_h, k_m, k_xi = _round_keys(rc.key, 3, draws)

        # client-side legs: gradients + Hessian-coefficient learning, then
        # one uplink reduction for the round
        S, L_n, counts = shift_update(
            lambda delta: self.hess_comp.compress(client_keys_for(R, self.hess_comp, k_h),
                                                  delta),
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
        v, vbits = self.model_comp(k_m if self.model_comp.stochastic else None, x_next - z)
        led = led.add(model_down=vbits)
        z_n = z + self.eta * v
        xi_n = xi_scalar(k_xi, self.p, device=z.device)
        return (z_n, w_n, L_n, H_n, grad_w_n, xi_n, led), ys


# ==========================================================================
# BL2 — Algorithm 2
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class BL2Spec(MethodSpec):
    """Partial participation: each round the server solves with the fleet
    means of the clients' carried (Hᵢ, lᵢ, gᵢ), broadcasts the compressed
    model to Bernoulli(τ/n) participants, and only they learn their
    Hessian coefficients and (with probability p) refresh their gradient
    term; absent clients' state is frozen."""

    hess_comp: Compressor
    model_comp: Compressor
    alpha: float
    eta: float
    p: float
    tau: int
    init_exact: bool
    init_hess_bits: float
    basis_bits: float
    block: bool

    supports_faults = True        # partial participation absorbs dropouts
    supports_cohort = True        # Alg. 2: absent clients' state freezes
    carry_names = ("z", "w", "L", "Hi", "li", "gi", "led")

    def cohort_aggregates(self):
        # the server system is assembled from raw per-client carry state
        # every round, so absent clients' frozen rows keep contributing
        return {"H": ("Hi", "mean"), "l": ("li", "mean"), "g": ("gi", "mean")}

    def prepare(self, R, batch, basisb, x0):
        return coeff_layout(R, batch, basisb, x0, self.block)

    def init(self, R, env):
        lay = env.extra
        x0 = env.x0
        x0b = x0.expand(R.n_local, env.batch.d)
        L0 = (lay.target_at(x0) if self.init_exact
              else torch.zeros(lay.shape, dtype=x0.dtype, device=x0.device))
        # recon's einsum comes out transposed in memory and every round's
        # update keeps its input's layout: start contiguous, the layout a
        # carry restored from a checkpoint has, so the reductions over Hᵢ
        # sum in one order whether the run was resumed or not
        Hi0 = (lay.recon(L0) + lay.ridge).contiguous()
        Hs0 = _sym_b(Hi0)
        li0 = _fro_b(Hs0 - client_batch.hess(env.batch, x0b))
        gi0 = (client_batch.bmv(Hs0, x0b) + li0[:, None] * x0b
               - client_batch.grads(env.batch, x0b))
        # the ledger stays on the host: every round adds the participants'
        # bit sums, moved there once (`CommLedger.add_fleet_sums`)
        led0 = CommLedger.create(hess_up=self.init_hess_bits, basis_ship=self.basis_bits)
        return (x0b, x0b, L0, Hi0, li0, gi0, led0)

    def step(self, R, env, carry, rc):
        z, w, L, Hi, li, gi, led = carry
        batch = env.batch
        d = batch.d
        lay = env.extra
        eye = torch.eye(d, dtype=env.x0.dtype, device=env.x0.device)

        # one uplink reduction for the server system, one solve per fleet
        red = R.reduce_tree({"H": Hi, "l": li, "g": gi})
        x_cur = R.once(lambda H, l_avg, g: torch.linalg.solve((H + H.T) / 2.0 + l_avg * eye, g),
                       red["H"], red["l"], red["g"])
        ys = (x_cur, led)  # gap evaluated at x_cur, after the loop

        k_part, k_m, k_h, k_xi = prng.split(rc.key, 4)
        part, pev = participation(R, k_part, self.tau, avail=rc.avail)

        # compressed model broadcast (participants only)
        z_n, dbits = downlink_broadcast(R, self.model_comp, k_m, z, x_cur, self.eta, part)

        # Hessian-coefficient learning
        S, L_plus, counts = shift_update(
            lambda delta: self.hess_comp.compress(client_keys_for(R, self.hess_comp, k_h),
                                                  delta),
            lay.target_at(z_n), L, self.alpha)
        sbits = comm.price(self.hess_comp.wire, counts)
        pm = part[:, None, None]
        L_n = torch.where(pm, L_plus, L)
        # each (n, d, d) stream is dropped once spent: at bl2-xl's widths
        # one is 5.9 GB (PERF.md §5: peak memory)
        del L_plus
        Hi_n = torch.where(pm, Hi + lay.recon(self.alpha * S), Hi)
        del S
        Hs_n = _sym_b(Hi_n)
        li_n = torch.where(part, _fro_b(Hs_n - client_batch.hess(batch, z_n)), li)

        xi = xi_mask(R, k_xi, self.p) & part
        w_n = torch.where(xi[:, None], z_n, w)
        # ξ=1: fresh g_i at the new w; ξ=0: server-reconstructed difference.
        # Non-participants: Hi_n = Hi and li_n = li exactly, so gi_recon = gi.
        gi_fresh = (client_batch.bmv(Hs_n, w_n) + li_n[:, None] * w_n
                    - client_batch.grads(batch, w_n))
        gi_recon = gi + client_batch.bmv(Hs_n - _sym_b(Hi), w) + (li_n - li)[:, None] * w
        del Hs_n
        gi_n = torch.where(xi[:, None], gi_fresh, gi_recon)

        g_bits = torch.where(xi, float(d * FLOAT_BITS), FLOAT_BITS + 1.0).to(torch.float64)
        bits = R.reduce_tree({"s": torch.where(part, sbits, 0.0),
                              "g": torch.where(part, g_bits, 0.0)}, "sum")
        led = _bill_fleet(R, led, bits, dbits)
        return (z_n, w_n, L_n, Hi_n, li_n, gi_n, led), (*ys, pev)


# ==========================================================================
# BL3 — Algorithm 3 (PSD basis of Example 5.1)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class BL3Spec(MethodSpec):
    """BL3: coefficients h̃(∇²fᵢ) in the PSD basis, the server system
    β·A − C assembled from carried per-client (Aᵢ, Cᵢ, g1ᵢ, g2ᵢ, βᵢ), with
    BL2's participation and gradient-refresh draws."""

    hess_comp: Compressor
    model_comp: Compressor
    alpha: float
    eta: float
    p: float
    tau: int
    c: float
    option: int

    supports_faults = True        # partial participation absorbs dropouts
    supports_cohort = True        # Alg. 3: absent clients' state freezes
    carry_names = ("z", "w", "zprev", "L", "gam", "A", "C", "g1", "g2", "beta", "led")

    def cohort_aggregates(self):
        return {"A": ("A", "mean"), "C": ("C", "mean"), "g1": ("g1", "mean"),
                "g2": ("g2", "mean"), "beta": ("beta", "max")}

    def prepare(self, R, batch, basisb, x0):
        return _psd_sum_matrix(batch.d, x0.dtype, x0.device)

    def init(self, R, env):
        Ssum = env.extra
        x0b = env.x0.expand(R.n_local, env.batch.d)
        L0 = _psd_h_tilde(client_batch.hess(env.batch, x0b))
        gam0 = torch.clamp(L0.abs().amax(dim=(1, 2)), min=self.c)
        A0 = _psd_reconstruct_full(L0) + 2.0 * gam0[:, None, None] * Ssum
        C0 = 2.0 * gam0[:, None, None] * Ssum
        # h̃(∇²f_i(w⁰)) = L⁰ at init, so β_i⁰ = 1 exactly
        beta0 = torch.ones((R.n_local,), dtype=env.x0.dtype, device=env.x0.device)
        g1_0 = client_batch.bmv(A0, x0b)
        g2_0 = client_batch.bmv(C0, x0b) + client_batch.grads(env.batch, x0b)
        led0 = CommLedger.create(hess_up=(env.batch.d * (env.batch.d + 1) // 2) * FLOAT_BITS)
        return (x0b, x0b, x0b, L0, gam0, A0, C0, g1_0, g2_0, beta0, led0)

    def step(self, R, env, carry, rc):
        z, w, zprev, L, gam, A_i, C_i, g1, g2, beta_i, led = carry
        batch = env.batch
        d = batch.d
        Ssum = env.extra

        # four means and the β max in one uplink reduction; the server
        # system assembles and solves once per fleet
        red = R.reduce_tree(
            {"A": A_i, "C": C_i, "g1": g1, "g2": g2, "beta": beta_i},
            {"A": "mean", "C": "mean", "g1": "mean", "g2": "mean", "beta": "max"})
        x_cur = R.once(
            lambda beta, A, C, g1m, g2m: torch.linalg.solve(beta * A - C, beta * g1m - g2m),
            red["beta"], red["A"], red["C"], red["g1"], red["g2"])
        ys = (x_cur, led)  # gap evaluated at x_cur, after the loop

        k_part, k_m, k_h, k_xi = prng.split(rc.key, 4)
        part, pev = participation(R, k_part, self.tau, avail=rc.avail)

        zprev_n = torch.where(part[:, None], z, zprev)
        z_n, dbits = downlink_broadcast(R, self.model_comp, k_m, z, x_cur, self.eta, part)

        target = _psd_h_tilde(client_batch.hess(batch, z_n))
        S, L_plus, counts = shift_update(
            lambda delta: self.hess_comp.compress(client_keys_for(R, self.hess_comp, k_h),
                                                  delta),
            target, L, self.alpha)
        sbits = comm.price(self.hess_comp.wire, counts)
        pm = part[:, None, None]
        L_n = torch.where(pm, L_plus, L)
        gam_n = torch.where(part, torch.clamp(L_n.abs().amax(dim=(1, 2)), min=self.c), gam)
        num = _psd_h_tilde(client_batch.hess(batch, zprev_n)) if self.option == 1 else target
        g2n = 2.0 * gam_n[:, None, None]
        beta_cand = ((num + g2n) / (L_n + g2n)).amax(dim=(1, 2))
        beta_i_n = torch.where(part, beta_cand, beta_i)
        dgam = (gam_n - gam)[:, None, None]
        A_n = torch.where(pm, A_i + _psd_reconstruct_full(L_n - L) + 2.0 * dgam * Ssum, A_i)
        C_n = torch.where(pm, C_i + 2.0 * dgam * Ssum, C_i)

        xi = xi_mask(R, k_xi, self.p) & part
        w_n = torch.where(xi[:, None], z_n, w)
        g1_fresh = client_batch.bmv(A_n, w_n)
        g2_fresh = client_batch.bmv(C_n, w_n) + client_batch.grads(batch, w_n)
        # non-participants: A_n = A_i, C_n = C_i ⇒ the recon branch keeps g1/g2
        g1_recon = g1 + client_batch.bmv(A_n - A_i, w)
        g2_recon = g2 + client_batch.bmv(C_n - C_i, w)
        g1_n = torch.where(xi[:, None], g1_fresh, g1_recon)
        g2_n = torch.where(xi[:, None], g2_fresh, g2_recon)

        # every participant's β_i reaches the server (one float, billed with
        # the Hessian leg; silent clients send nothing)
        g_bits = torch.where(xi, 2.0 * d * FLOAT_BITS, 2.0 * FLOAT_BITS + 1.0).to(torch.float64)
        bits = R.reduce_tree({"s": torch.where(part, sbits + FLOAT_BITS, 0.0),
                              "g": torch.where(part, g_bits, 0.0)}, "sum")
        led = _bill_fleet(R, led, bits, dbits)
        return ((z_n, w_n, zprev_n, L_n, gam_n, A_n, C_n, g1_n, g2_n, beta_i_n, led),
                (*ys, pev))


# ==========================================================================
# First-order baselines: GD, DIANA
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class GDSpec(MethodSpec):
    """Distributed gradient descent: d floats a client a round."""

    lr: float

    def init(self, R, env):
        return (env.x0, CommLedger.create(device=env.x0.device))

    def step(self, R, env, carry, rc):
        x, led = carry
        x_n = x - self.lr * global_grad(R, env.batch, x)
        return (x_n, led.add(grad_up=env.batch.d * FLOAT_BITS)), (x, led, EVENT_NONE)


@dataclasses.dataclass(frozen=True)
class DianaSpec(MethodSpec):
    """DIANA: every client sends C(∇fᵢ − hᵢ) with its round key and moves
    its shift hᵢ by α_h of it; the server steps with the mean of hᵢ + C(·)."""

    comp: Compressor
    alpha_h: float
    lr: float

    def init(self, R, env):
        h0 = torch.zeros((R.n_local, env.batch.d), dtype=env.x0.dtype, device=env.x0.device)
        return (env.x0, h0, CommLedger.create(device=env.x0.device))

    def step(self, R, env, carry, rc):
        x, h, led = carry
        gi = client_batch.grads(env.batch, x)
        q, counts = self.comp.compress(client_keys_for(R, self.comp, rc.key), gi - h)
        red = R.reduce_tree({"ghat": h + q, "bits": comm.price(self.comp.wire, counts)})
        h_n = h + self.alpha_h * q
        x_n = x - self.lr * red["ghat"]
        return (x_n, h_n, led.add(grad_up=red["bits"])), (x, led, EVENT_NONE)


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
        return ((x_n, led.add(hess_up=self.hess_bits, grad_up=self.grad_bits)),
                (x, led, EVENT_NONE))


# ==========================================================================
# FedNL-BAG — FedNL's Hessian learning + Bernoulli gradient aggregation
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class FedNLBAGSpec(MethodSpec):
    """Newton-type method with compressed Hessian learning and a
    Bernoulli-lazy gradient uplink (after arXiv 2206.03588): every round
    each client reports its exact gradient with probability q, the server
    keeps the latest gradient of every client and takes the damped,
    μ-projected Newton step with the mean of that table.

    The ledger stays on the host: every round adds the fleet sums of both
    legs (`comm.CommLedger.add_fleet_sums`), rounded once as the
    reference's compiled round adds ``sum / n``."""

    hess_comp: Compressor
    alpha: float
    q: float
    eta: float
    mu: float
    init_exact: bool
    init_hess_bits: float
    basis_bits: float
    block: bool

    supports_faults = True        # the lazy table reuses silent clients' rows
    supports_cohort = True        # the lazy table is frozen absent state
    carry_names = ("z", "L", "H", "gtab", "led")

    def cohort_aggregates(self):
        # ĝ is the mean of the raw gradient table: absent clients' stale
        # rows keep contributing.  dH and the bits are delta-style (absent
        # clients add 0), so they are not declared
        return {"ghat": ("gtab", "mean")}

    def cohort_init_extras(self, R, env, carry):
        # H⁰ = meanᵢ recon(L⁰ᵢ) + ridge is a fleet reduction: the engine
        # sums the per-client reconstructions over its init slabs
        _, L0, _, _, _ = carry
        return {"recL": env.extra.recon(L0)}

    def cohort_server_init(self, env, sums, n_total, carry):
        return {"H": sums["recL"] / n_total + env.extra.ridge}

    def prepare(self, R, batch, basisb, x0):
        return coeff_layout(R, batch, basisb, x0, self.block)

    def init(self, R, env):
        lay = env.extra
        x0 = env.x0
        L0 = (lay.target_at(x0) if self.init_exact
              else torch.zeros(lay.shape, dtype=x0.dtype, device=x0.device))
        H0 = R.mean(lay.recon(L0)) + lay.ridge
        gtab0 = client_batch.grads(env.batch, x0)     # exact initial gradients
        led0 = CommLedger.create(hess_up=self.init_hess_bits,
                                 grad_up=env.batch.d * FLOAT_BITS,
                                 basis_ship=self.basis_bits)
        return (x0, L0, H0, gtab0, led0)

    def step(self, R, env, carry, rc):
        z, L, H, gtab, led = carry
        batch = env.batch
        lay = env.extra

        k_h, k_b = prng.split(rc.key, 2)
        # reporters refresh their row of the table; silent clients' stale
        # rows are reused.  Clients the fault layer marks unavailable stay
        # silent, and the event stream records the outage
        send = prng.bernoulli(k_b, self.q, (R.n,), device=R.device)
        if rc.avail is None:
            ev = EVENT_NONE
        else:
            avail = rc.avail.to(device=R.device, dtype=torch.bool)
            n_av = avail.sum()
            ev = (EVENT_DEGRADED * (n_av < R.n) + EVENT_ALL_DOWN * (n_av == 0)).to(torch.int32)
            send = send & avail
        ys = (z, led, ev)  # gap evaluated at z, after the loop
        note_uploads(R, send)
        gtab_n = torch.where(send[:, None], client_batch.grads(batch, z), gtab)

        S, L_n, counts = shift_update(
            lambda delta: self.hess_comp.compress(client_keys_for(R, self.hess_comp, k_h),
                                                  delta),
            lay.target_at(z), L, self.alpha)
        red = R.reduce_tree(
            {"ghat": gtab_n, "dH": lay.recon(self.alpha * S),
             "gbits": torch.where(send, float(batch.d * FLOAT_BITS), 0.0).to(torch.float64),
             "sbits": comm.price(self.hess_comp.wire, counts)},
            {"ghat": "mean", "dH": "mean", "gbits": "sum", "sbits": "sum"})
        s, g = torch.stack([red["sbits"], red["gbits"]]).tolist()
        led = led.add_fleet_sums(R.n_total, hess_up=s, grad_up=g)
        H_n = H + red["dH"]

        # damped Newton step (η = 1 and q = 1 recover FedNL), once a fleet
        z_n = R.once(
            lambda H_n, ghat: z - self.eta * torch.linalg.solve(proj_mu(H_n, self.mu), ghat),
            H_n, red["ghat"])
        return (z_n, L_n, H_n, gtab_n, led), ys


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
        ys = (params, led, EVENT_NONE)  # evaluated after the loop
        basis = env.basisb

        # per-client gradients, rotated into the per-layer basis
        g = torch.func.vmap(torch.func.grad(self.loss_fn), in_dims=(None, 0))(
            params, env.batch.data)
        coeff = g if basis is None else basis.rotate(g)
        n_leaves = len(tree_leaves(params))
        draws = any(c.stochastic for c in self.grad_comps + self.fisher_comps)
        k_g, k_f = _round_keys(rc.key, 2, draws)
        gks = _round_keys(k_g, n_leaves, draws)
        S, shift_n, gauxs = tree_shift_update(
            lambda i, delta: self.grad_comps[i].compress(
                client_keys_for(R, self.grad_comps[i], gks[i]), delta),
            coeff, shift, self.alpha)
        gbits = self._bill(self.grad_comps, gauxs)

        if self.precondition:
            # the second-order leg: the Fisher diagonal g² through the same
            # recursion, with the fused compress-then-sum codec
            ftarget = tree_map(lambda gi: gi.to(torch.float32).square(), g)
            fks = _round_keys(k_f, n_leaves, draws)
            Fc, fshift_n, fauxs, fsums = tree_shift_update_sum(
                lambda i, delta: self.fisher_comps[i].compress_sum(
                    client_keys_for(R, self.fisher_comps[i], fks[i]), delta),
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
