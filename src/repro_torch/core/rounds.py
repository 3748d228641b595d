"""Round engine, single-device subset — port of `repro.core.rounds`.

Every method shares one round skeleton: local Hessian/gradient compute →
compressed-difference uplink → server aggregate → downlink.  This module
holds that skeleton's pieces as plain functions on client-stacked tensors:

  * the `VmapReducer`: cross-client reductions over the leading axis, on
    tensors and on pytrees (nested dicts, `repro_torch.core.pytree`);
  * the combinators: the compressed-shift recursion (`shift_update`, its
    pytree and fused compress-sum forms for BL-DNN), the BL1 gradient-leg
    switch (`xi_scalar`), the basis-refresh boundary (`refresh_due`), the
    §2.3 coefficient layouts (`coeff_layout`: compact (n, r, r) blocks or
    full (n, d, d));
  * `run_rounds`: a Python loop over rounds (the reference's
    `lax.scan`), with the trajectory evaluated after the loop
    (`default_gap_stream`) as the reference does.

The sharded reducer (ROADMAP.md §1 item 13), the mid-sweep stream hook
(item 11) and the PRNG draws of p < 1 (item 9) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from . import client_batch, comm
from .pytree import tree_leaves, tree_map, tree_unflatten

_REDUCE_OPS = ("mean", "sum")


@dataclasses.dataclass(frozen=True)
class VmapReducer:
    """Single-device backend: the client axis is a plain leading axis."""

    n: int

    @property
    def n_local(self) -> int:
        return self.n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

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


@dataclasses.dataclass
class RoundCtx:
    """Per-round context handed to `MethodSpec.step`: ``t`` is the 0-based
    round index.  (The reference's per-round PRNG key comes with the PRNG
    port; the deterministic path draws nothing.)"""

    t: int


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


def xi_scalar(p: float, *, device=None) -> torch.Tensor:
    """Fleet-wide scalar ξ (BL1's single gradient-leg switch)."""
    if p >= 1.0:
        return torch.tensor(True, device=device)
    raise NotImplementedError(
        f"p={p} < 1 draws ξ from JAX's PRNG stream, which is not ported "
        "yet: ROADMAP.md §1 item 9 (PRNG) brings it")


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


def default_gap_stream(batch, xs_t: torch.Tensor, f_star: torch.Tensor) -> torch.Tensor:
    """f(x_t) − f* for a whole (steps, d) GLM trajectory, evaluated after
    the round loop (the default `MethodSpec.eval_streams`)."""
    return torch.stack([client_batch.losses(batch, x).mean() for x in xs_t]) - f_star


def run_rounds(spec, batch, basisb, x0, f_star, steps: int, *,
               sharded: bool = False, stream=None):
    """Run `steps` rounds of `spec` on one device and return
    ``(evals, ledger_streams)``: ``evals`` is the dict of (steps,) streams
    from ``spec.eval_streams`` (always holding ``"gap"``), the ledger holds
    one (steps,) cumulative bit stream per leg, recorded at the start of
    each round as the reference's scan does.  ``x0`` is a tensor or a
    parameter pytree; the trajectory reaches ``eval_streams`` stacked leaf
    by leaf, (steps, ...)."""
    if sharded:
        raise NotImplementedError(
            "the sharded reducer is not ported yet: ROADMAP.md §1 item 13 "
            "(torch.distributed reducer) brings it")
    if stream is not None:
        raise NotImplementedError(
            "StreamHook is not ported yet: ROADMAP.md §1 item 11 "
            "(experiment layer) brings it")
    if steps < 1:
        raise ValueError(f"run_rounds needs steps >= 1, got {steps}")
    R = VmapReducer(n=batch.n)
    env = Env(batch=batch, basisb=basisb, x0=x0,
              extra=spec.prepare(R, batch, basisb, x0))
    carry = spec.init(R, env)
    xs, leds = [], []
    for t in range(int(steps)):
        carry, (eval_x, led) = spec.step(R, env, carry, RoundCtx(t=t))
        xs.append(eval_x)
        leds.append(led)
    evals = spec.eval_streams(batch, tree_map(lambda *x: torch.stack(x), *xs), f_star)
    return evals, comm.CommLedger.stack(leds)
