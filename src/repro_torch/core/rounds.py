"""Round engine, single-device subset — port of `repro.core.rounds`.

Every method shares one round skeleton: local Hessian/gradient compute →
compressed-difference uplink → server aggregate → downlink.  This module
holds that skeleton's pieces as plain functions on client-stacked tensors:

  * the `VmapReducer`: cross-client reductions over the leading axis, on
    tensors and on pytrees (nested dicts, `repro_torch.core.pytree`), and
    the per-client PRNG keys (`client_keys`);
  * the combinators: the compressed-shift recursion (`shift_update`, its
    pytree and fused compress-sum forms for BL-DNN), Bernoulli(τ/n)
    participation with the force-one-client fallback (`participation`),
    the gradient-leg switches (`xi_scalar` for BL1, `xi_mask` for BL2/BL3),
    the compressed model-stream downlink (`downlink_broadcast`), the
    basis-refresh boundary (`refresh_due`), the §2.3 coefficient layouts
    (`coeff_layout`: compact (n, r, r) blocks or full (n, d, d));
  * `run_rounds`: a Python loop over rounds (the reference's
    `lax.scan`) fed the per-round keys ``split(PRNGKey(seed), steps)``,
    with the trajectory evaluated after the loop (`default_gap_stream`) as
    the reference does, and an optional mid-sweep `StreamHook`.

Keys follow `repro_torch.core.prng`: a round's key and the keys split from
it stay on the host, and every draw over the client or an entry axis runs
on the reducer's device.  Compressors that draw nothing get no keys (the
reference derives them and ignores them, which changes no bit).

The sharded reducer (ROADMAP.md §1 item 13) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import client_batch, comm, prng
from .pytree import tree_leaves, tree_map, tree_unflatten

_REDUCE_OPS = ("mean", "sum", "max")


@dataclasses.dataclass(frozen=True)
class VmapReducer:
    """Single-device backend: the client axis is a plain leading axis on
    ``device``, where the fleet-wide draws run."""

    n: int
    device: torch.device = torch.device("cpu")

    @property
    def n_local(self) -> int:
        return self.n

    @property
    def n_total(self) -> int:
        """The fleet size: the denominator of per-node bit accounting."""
        return self.n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def client_keys(self, key: torch.Tensor) -> torch.Tensor:
        """Per-client PRNG keys, (n, 2) on the device: ``split(key, n)``."""
        return prng.split(key, self.n, device=self.device)

    def reduce_tree(self, tree: dict, ops="mean") -> dict:
        """Reduce a pytree of client-stacked uplink legs in one call;
        ``ops`` is one op for every leaf or a tree of ops shaped like
        `tree` (a leg that is itself a pytree may take one op for all its
        leaves)."""
        if not isinstance(ops, str):
            return {name: self.reduce_tree(x, ops[name]) for name, x in tree.items()}
        if ops not in _REDUCE_OPS:
            raise ValueError(f"reduce_tree op must be one of {_REDUCE_OPS}, got {ops!r}")
        return tree_map(getattr(self, ops), tree)

    def tree_mean(self, tree):
        """`mean` over the client axis of every leaf of a pytree."""
        return self.reduce_tree(tree, "mean")

    def tree_mean_presummed(self, tree, local_sums):
        """Fleet mean of client-stacked leaves given their local client-axis
        sums (the extra output of `Compressor.compress_sum`).  This exact
        single-device reducer ignores the sums and reduces `tree` itself,
        as the reference's does."""
        del local_sums
        return self.tree_mean(tree)

    def once(self, f: Callable, *args):
        """Run server-only math ``f(*args)`` once per fleet."""
        return f(*args)


#: `participation`'s per-round event bits (OR-combined)
EVENT_NONE = 0
#: faults shrank the round's surviving cohort below its τ target
EVENT_DEGRADED = 1
#: the force-one-client fallback engaged (empty cohort after the draw/faults)
EVENT_FORCED = 2
#: no client was available at all — the round stalls (nothing participates)
EVENT_ALL_DOWN = 4


@dataclasses.dataclass
class RoundCtx:
    """Per-round context handed to `MethodSpec.step`: ``t`` is the 0-based
    round index, ``key`` the round's PRNG key (a (2,) host tensor) and
    ``avail`` an optional fleet-wide (n,) bool availability mask (None: the
    batch driver, every client reachable)."""

    t: int
    key: Optional[torch.Tensor] = None
    avail: Optional[torch.Tensor] = None


def refresh_due(t: int, rounds_per_refresh: int) -> bool:
    """Basis-refresh boundary: True at rounds where an amortized basis
    shipment may re-ship (``t % T == 0`` for ``T ≥ 1``; never for
    ``T ≤ 0``, the ship-once policy).  A function of the absolute round
    index only."""
    T = int(rounds_per_refresh)
    return T > 0 and int(t) % T == 0


# ==========================================================================
# Round-step combinators
# ==========================================================================
def shift_update(compress: Callable, target: torch.Tensor, shift: torch.Tensor,
                 alpha: float) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """One step of the compressed-difference shift recursion (Alg. 1 core):
    S = C(target − L), L ← L + α·S.  Returns (S, new_shift, aux)."""
    S, aux = compress(target - shift)
    return S, shift + alpha * S, aux


def _leaf_pairs(target, shift):
    t_leaves, s_leaves = tree_leaves(target), tree_leaves(shift)
    if len(t_leaves) != len(s_leaves):
        raise ValueError(
            f"target/shift leaf mismatch: {len(t_leaves)} vs {len(s_leaves)}")
    return list(zip(t_leaves, s_leaves))


def tree_shift_update(compress: Callable, target, shift, alpha: float):
    """`shift_update` over pytrees, one recursion per leaf:
    ``compress(i, delta) -> (dense, aux)`` compresses leaf i (leaf order of
    `tree_leaves`).  Returns ``(S, new_shift, auxs)``: two trees shaped
    like `target` and the per-leaf aux records as a tuple."""
    outs = [shift_update(lambda d, i=i: compress(i, d), t, s, alpha)
            for i, (t, s) in enumerate(_leaf_pairs(target, shift))]
    return (tree_unflatten(target, [o[0] for o in outs]),
            tree_unflatten(target, [o[1] for o in outs]),
            tuple(o[2] for o in outs))


def shift_update_sum(compress_sum: Callable, target: torch.Tensor,
                     shift: torch.Tensor, alpha: float):
    """`shift_update` through a fused compress-then-reduce codec,
    ``compress_sum(delta) -> (dense, aux, local_sum)``.  Returns
    ``(S, new_shift, aux, local_sum)``."""
    S, aux, s_local = compress_sum(target - shift)
    return S, shift + alpha * S, aux, s_local


def tree_shift_update_sum(compress_sum: Callable, target, shift, alpha: float):
    """`tree_shift_update` through fused codecs, ``compress_sum(i, delta)
    -> (dense, aux, local_sum)``.  Returns ``(S, new_shift, auxs,
    local_sums)``."""
    outs = [shift_update_sum(lambda d, i=i: compress_sum(i, d), t, s, alpha)
            for i, (t, s) in enumerate(_leaf_pairs(target, shift))]
    return (tree_unflatten(target, [o[0] for o in outs]),
            tree_unflatten(target, [o[1] for o in outs]),
            tuple(o[2] for o in outs),
            tree_unflatten(target, [o[3] for o in outs]))


def participation(R: VmapReducer, key: torch.Tensor, tau: int,
                  avail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli(τ/n) participation mask over the fleet, with the
    force-one-client fallback, from the split keys (mask, fallback index)
    of ``key``.  τ < 1 raises ``ValueError``; τ ≥ n is full participation
    (every uniform is below 1, so nothing is drawn).

    ``avail`` is an optional (n,) bool availability mask: drawn clients
    that are down are removed, and when none survives the fallback forces
    one *available* client (its index rotated onto the available subset;
    all-ones reproduces the unmasked path bitwise).  Returns ``(mask,
    event)``, ``event`` an int32 tensor of `EVENT_*` bits."""
    tau = int(tau)
    if tau < 1:
        raise ValueError(
            f"participation needs τ ≥ 1 expected clients per round, got "
            f"τ={tau} — pass τ in [1, n] (τ=n is full participation)")
    n, dev = R.n, R.device
    ar = torch.arange(n, device=dev)
    if tau >= n:
        drawn, idx = torch.ones(n, dtype=torch.bool, device=dev), 0
    else:
        k_mask, k_idx = prng.split(key)
        drawn = prng.bernoulli(k_mask, tau / n, (n,), device=dev)
        idx = int(prng.randint(k_idx, (), 0, n))
    if avail is None:
        forced = ~drawn.any() & (ar == idx)
        event = torch.where(forced.any(), EVENT_FORCED, EVENT_NONE)
        return drawn | forced, event.to(torch.int32)
    avail = avail.to(device=dev, dtype=torch.bool)
    n_avail = avail.sum()
    surviving = drawn & avail
    n_surv = surviving.sum()
    pick = avail & (torch.cumsum(avail, 0) == idx % torch.clamp(n_avail, min=1) + 1)
    need_force = (n_surv == 0) & (n_avail > 0)
    part = surviving | (need_force & pick)
    event = (EVENT_DEGRADED * ((n_surv < drawn.sum()) & (n_surv < tau))
             + EVENT_FORCED * need_force + EVENT_ALL_DOWN * (n_avail == 0))
    return part, event.to(torch.int32)


def xi_mask(R: VmapReducer, key: torch.Tensor, p: float) -> torch.Tensor:
    """Per-client ξ ~ Bernoulli(p) gradient-refresh mask, (n,) bool."""
    if p >= 1.0:
        return torch.ones(R.n, dtype=torch.bool, device=R.device)
    return prng.bernoulli(key, p, (R.n,), device=R.device)


def xi_scalar(key: torch.Tensor, p: float, *, device=None) -> torch.Tensor:
    """Fleet-wide scalar ξ (BL1's single gradient-leg switch), drawn on the
    host and placed on ``device``."""
    if p >= 1.0:
        return torch.tensor(True, device=device)
    return prng.bernoulli(key, p, (1,))[0].to(device)


def client_keys_for(R: VmapReducer, comp, key: torch.Tensor):
    """``R.client_keys(key)`` for a compressor that draws, None for one
    that does not."""
    return None if comp.deterministic else R.client_keys(key)


def downlink_broadcast(R: VmapReducer, comp, key: torch.Tensor, z: torch.Tensor,
                       x_target: torch.Tensor, eta: float, part: torch.Tensor):
    """Compressed model-stream downlink to participating clients:
    z_i ← z_i + η·C_i(x − z_i).  Returns (z_new, down_bits_fleet_sum): the
    reference returns the sum's per-node share, which the port's ledger
    takes with `comm.CommLedger.add_fleet_sums`."""
    v, counts = comp.compress(client_keys_for(R, comp, key), x_target[None, :] - z)
    vbits = comm.price(comp.wire, counts)
    z_n = torch.where(part[:, None], z + eta * v, z)
    return z_n, R.sum(torch.where(part, vbits, 0.0))


def global_grad(R: VmapReducer, batch, x: torch.Tensor) -> torch.Tensor:
    return R.mean(client_batch.grads(batch, x))


# ==========================================================================
# Coefficient layouts (§2.3): block (n, r, r) vs full (n, d, d)
# ==========================================================================
@dataclasses.dataclass
class CoeffLayout:
    """`target_at(z)` gives the per-client coefficient target, `recon(S)`
    maps coefficient updates to (n, d, d) Hessian space, `shape` is the
    coefficient-state shape, `ridge` the analytic λI for data bases."""

    target_at: Callable
    recon: Callable
    shape: Tuple[int, ...]
    ridge: torch.Tensor


def coeff_layout(R: VmapReducer, batch, basisb, x0: torch.Tensor,
                 block: bool) -> CoeffLayout:
    d = batch.d
    lam = batch.lam
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    if block:
        # §2.3 block mode (data basis only): state stays (n, r, r) and the
        # d×d data Hessian is never materialized (Γ = (AV)ᵀD(AV)/m).
        AV = client_batch.basis_AV(basisb, batch)
        rb = basisb.r_max
        return CoeffLayout(
            target_at=lambda z: client_batch.hess_coeff_block(basisb, batch, z, AV),
            recon=lambda S: client_batch.reconstruct_block(basisb, S),
            shape=(R.n_local, rb, rb),
            ridge=lam * eye,
        )
    ridge = lam * eye if basisb.kind == "data_outer" else torch.zeros_like(eye)
    return CoeffLayout(
        target_at=lambda z: client_batch.hess_coeff_target(basisb, batch, z),
        recon=basisb.reconstruct,
        shape=(R.n_local, d, d),
        ridge=ridge,
    )


# ==========================================================================
# Driver
# ==========================================================================
@dataclasses.dataclass
class Env:
    """Per-run context handed to spec.init/step."""

    batch: object
    basisb: object
    x0: object     # (d,) iterate, or a parameter pytree (BL-DNN)
    extra: object  # spec-specific precomputation (e.g. a CoeffLayout)


@dataclasses.dataclass(frozen=True)
class StreamHook:
    """Mid-sweep instrumentation hook for long runs (`repro_torch.exp`
    sweeps): `run_rounds` calls ``callback(t, eval_x, ledger)`` at rounds
    t = 0, every, 2·every, … with round t's own outputs — its evaluation
    iterate and the cumulative per-leg `comm.CommLedger` that
    ``spec.step`` returned for it, as row 0 of the reference's chunk of
    ``every`` rounds gives them.  Instrumentation only: the loop is the
    same with or without a hook, so histories are bitwise unchanged."""

    every: int
    callback: Callable

    def _emit(self, t, eval_x, ledger):
        self.callback(int(t), eval_x, ledger)


def default_gap_stream(batch, xs_t: torch.Tensor, f_star: torch.Tensor) -> torch.Tensor:
    """f(x_t) − f* for a whole (steps, d) GLM trajectory, evaluated after
    the round loop (the default `MethodSpec.eval_streams`)."""
    return torch.stack([client_batch.losses(batch, x).mean() for x in xs_t]) - f_star


def run_rounds(spec, batch, basisb, x0, f_star, steps: int, *, seed: int = 0,
               sharded: bool = False, stream=None):
    """Run `steps` rounds of `spec` on one device and return
    ``(evals, ledger_streams)``: ``evals`` is the dict of (steps,) streams
    from ``spec.eval_streams`` (always holding ``"gap"``), the ledger holds
    one (steps,) cumulative bit stream per leg, recorded at the start of
    each round as the reference's scan does.  ``x0`` is a tensor or a
    parameter pytree; the trajectory reaches ``eval_streams`` stacked leaf
    by leaf, (steps, ...).  Round t's key is row t of
    ``split(PRNGKey(seed), steps)``, as the reference's batch driver
    splits them (`repro.core.batched._run`).  ``stream`` is an optional
    `StreamHook`."""
    if sharded:
        raise NotImplementedError(
            "the sharded reducer is not ported yet: ROADMAP.md §1 item 13 "
            "(torch.distributed reducer) brings it")
    if steps < 1:
        raise ValueError(f"run_rounds needs steps >= 1, got {steps}")
    R = VmapReducer(n=batch.n, device=tree_leaves(x0)[0].device)
    env = Env(batch=batch, basisb=basisb, x0=x0,
              extra=spec.prepare(R, batch, basisb, x0))
    carry = spec.init(R, env)
    keys = prng.split(prng.PRNGKey(seed), int(steps))
    every = None if stream is None else max(1, int(stream.every))
    xs, leds = [], []
    for t in range(int(steps)):
        carry, (eval_x, led) = spec.step(R, env, carry, RoundCtx(t=t, key=keys[t]))
        if every is not None and t % every == 0:
            stream._emit(t, eval_x, led)
        xs.append(eval_x)
        leds.append(led)
    evals = spec.eval_streams(batch, tree_map(lambda *x: torch.stack(x), *xs), f_star)
    return evals, comm.CommLedger.stack(leds)
