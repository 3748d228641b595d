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
    the reference does, and an optional mid-sweep `StreamHook`;
  * the chunked driver (`serve_init`, `init_serve_carry`, `run_chunk`):
    rounds [t0, t0 + steps) from an explicit carry, round t keyed
    ``fold_in(root_key, t)``, so a trajectory does not depend on where it
    is cut, under an optional availability schedule from the fault layer
    (`repro_torch.core.faults`); `carry_client_flags` tells the carry's
    client-stacked elements from its server ones, and `carry_leaves` /
    `carry_from_leaves` are the carry's checkpoint leaf order (the
    reference's ``jax.tree_util`` flattening);
  * the cohort chunk (`CohortReducer`, `run_cohort_chunk`): the rounds of
    one epoch of the cohort-streaming engine (`repro_torch.core.cohort`),
    the spec seeing a sampled cohort as the fleet.

Keys follow `repro_torch.core.prng`: a round's key and the keys split from
it stay on the host, and every draw over the client or an entry axis runs
on the reducer's device.  Compressors that draw nothing get no keys (the
reference derives them and ignores them, which changes no bit).

The sharded reducer (ROADMAP.md §1 item 13) and the program cache (item 16,
the reference's `warm_chunk_program` and `warm_cohort_chunk_program`) are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
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


class CohortReducer:
    """Reducer view of a sampled cohort standing in for the whole fleet.

    Wraps the cohort's `VmapReducer` ``inner`` so a spec's `step` runs
    unchanged: ``n``, ``n_local``, ``device``, `client_keys` and `once` are
    the cohort axis's; ``n_total`` is the fleet's size, so bills and
    participation stay fleet-denominated; ``idx`` holds each slot's global
    client index.  `reduce_tree` adds the host's ``frozen`` sums of the
    absent clients' state to a ``mean`` (and takes the max with their max
    for ``max``); a ``mean`` without a frozen entry is delta-style and
    divides the cohort's sum alone by ``n_total``.  Bare `mean` and `max`
    raise: an unnamed fleet reduction cannot be matched to a frozen
    statistic.  ``uploads`` collects each round's upload mask over the
    cohort (`note_uploads`), so the engine can report who took part."""

    is_cohort = True

    def __init__(self, inner: VmapReducer, idx: torch.Tensor, frozen: dict, n_global: int):
        self.inner = inner
        self.idx = idx
        self.frozen = frozen
        self.n_global = int(n_global)
        self.uploads: list = []

    # ---- cohort axis (delegated) ------------------------------------------
    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def n_local(self) -> int:
        return self.inner.n_local

    @property
    def n_total(self) -> int:
        return self.n_global

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def client_keys(self, key: torch.Tensor) -> torch.Tensor:
        return self.inner.client_keys(key)

    def once(self, f: Callable, *args):
        return self.inner.once(f, *args)

    # ---- fleet reductions --------------------------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Fleet sum of a quantity absent clients hold at 0 (participation
        masks, bit counts)."""
        return self.inner.sum(x)

    def mean(self, x):
        raise NotImplementedError(
            "CohortReducer cannot take an unnamed fleet mean: absent clients' "
            "contributions live in named frozen sums; use reduce_tree({'name': x})")

    def max(self, x):
        raise NotImplementedError(
            "CohortReducer cannot take an unnamed fleet max: use reduce_tree with a "
            "named leaf and a frozen fleet statistic")

    def reduce_tree(self, tree, ops="mean") -> dict:
        if not isinstance(tree, dict):
            raise NotImplementedError(
                "CohortReducer.reduce_tree needs a flat {name: leaf} dict (frozen "
                f"fleet statistics are matched by name); got {type(tree)}")
        ops_d = {name: ops for name in tree} if isinstance(ops, str) else dict(ops)
        for name in tree:
            if ops_d[name] not in _REDUCE_OPS:
                raise ValueError(f"reduce_tree op must be one of {_REDUCE_OPS}, "
                                 f"got {ops_d[name]!r}")
        red = self.inner.reduce_tree(
            tree, {name: "max" if ops_d[name] == "max" else "sum" for name in tree})
        out = {}
        for name in tree:
            op = ops_d[name]
            if op == "sum":
                out[name] = red[name]
            elif op == "mean":
                froz = self.frozen.get(name)
                s = red[name] if froz is None else froz + red[name]
                out[name] = s / self.n_total
            else:
                if name not in self.frozen:
                    raise ValueError(
                        f"max-aggregate {name!r} needs a frozen fleet statistic (the "
                        "absent clients' max); the cohort engine computes one an epoch")
                out[name] = torch.maximum(self.frozen[name], red[name])
        return out

    def tree_mean(self, tree):
        raise NotImplementedError(
            "pytree coefficient streams (BL-DNN) are not cohort-capable")

    def tree_mean_presummed(self, tree, local_sums):
        raise NotImplementedError(
            "pytree coefficient streams (BL-DNN) are not cohort-capable")


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
    if getattr(R, "is_cohort", False):
        return _cohort_participation(R, key, tau, avail)
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


def _cohort_participation(R: CohortReducer, key: torch.Tensor, tau: int, avail
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Participation over a sampled cohort: each slot draws
    Bernoulli(τ/n_total) from ``fold_in(k_mask, its global index)``, so a
    client's draw for a round depends only on the round key and its id
    (one hash over the cohort's (c, 2) keys).  The force-one-client
    fallback picks the slot with the least global index.  Fault injection
    is refused: availability masks address the stacked fleet."""
    if avail is not None:
        raise ValueError(
            "cohort streaming does not support fault injection (avail must be None): "
            "fault plans address the stacked fleet by index")
    tau = min(tau, R.n_total)
    k_mask, _ = prng.split(key)
    keys_i = prng.fold_in(k_mask, R.idx)
    drawn = prng.bernoulli(keys_i, tau / R.n_total, ())
    n_surv = R.sum(drawn.to(torch.int32))
    need = n_surv == 0
    part = drawn | (need & (R.idx == R.idx.amin()))
    event = torch.where(need, EVENT_FORCED, EVENT_NONE)
    note_uploads(R, part)
    return part, event.to(torch.int32)


def note_uploads(R, mask: torch.Tensor) -> None:
    """Record a round's upload mask (participants, or FedNL-BAG's
    reporters) on a `CohortReducer`; other reducers keep nothing."""
    if getattr(R, "is_cohort", False):
        R.uploads.append(mask)


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
        carry, (eval_x, led, _event) = spec.step(R, env, carry, RoundCtx(t=t, key=keys[t]))
        if every is not None and t % every == 0:
            stream._emit(t, eval_x, led)
        xs.append(eval_x)
        leds.append(led)
    evals = spec.eval_streams(batch, tree_map(lambda *x: torch.stack(x), *xs), f_star)
    return evals, comm.CommLedger.stack(leds)


# ==========================================================================
# Chunked driver: rounds [t0, t0 + steps) from an explicit carry
# ==========================================================================
def _device_of(x0) -> torch.device:
    return tree_leaves(x0)[0].device


def _elem_shapes(elem) -> list:
    """The shapes of a carry element's leaves: a tensor, a `CommLedger` or
    a pytree of tensors."""
    if isinstance(elem, comm.CommLedger):
        return [tuple(getattr(elem, leg).shape) for leg in comm.CommLedger.LEGS]
    return [tuple(leaf.shape) for leaf in tree_leaves(elem)]


def _meta(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    shape = tuple(x.shape) if n is None else (n,) + tuple(x.shape[1:])
    return torch.empty(shape, dtype=x.dtype, device="meta")


def serve_init(spec, R, batch, basisb, x0):
    """The round-0 carry: ``spec.init`` after ``spec.prepare``, the init
    the stacked driver and the cohort engine's fleet init share."""
    env = Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(R, batch, basisb, x0))
    return spec.init(R, env)


def carry_client_flags(spec, batch, basisb, x0) -> tuple:
    """Which carry elements are client-stacked: one tuple of flags (one a
    leaf) per top-level carry element.  ``spec.init`` runs on shapes only
    (``torch.device("meta")``) at n and at 2n clients, and exactly the
    leaves whose shape moved carry the client axis; no spec declares
    anything."""
    n = batch.n

    def shapes_at(nn: int) -> list:
        b = client_batch.ClientBatch(A=_meta(batch.A, nn), b=_meta(batch.b, nn), lam=batch.lam)
        bb = basisb
        if basisb is not None and not getattr(spec, "basis_replicated", False):
            bb = dataclasses.replace(basisb, **{f: _meta(getattr(basisb, f), nn)
                                                for f in ("V", "Q")
                                                if getattr(basisb, f) is not None})
        xm = tree_map(_meta, x0)
        carry = serve_init(spec, VmapReducer(n=nn, device=torch.device("meta")), b, bb, xm)
        return [_elem_shapes(e) for e in carry]

    s1, s2 = shapes_at(n), shapes_at(2 * n)
    return tuple(tuple(a != b for a, b in zip(e1, e2)) for e1, e2 in zip(s1, s2))


def init_serve_carry(spec, batch, basisb, x0):
    """The round-0 carry of the chunked driver on ``x0``'s device."""
    return serve_init(spec, VmapReducer(n=batch.n, device=_device_of(x0)), batch, basisb, x0)


def _stack_streams(outs: list) -> tuple:
    """(eval_x, ledger, event) of each round → (steps, ...) streams."""
    xs, leds, evs = zip(*outs)
    dev = _device_of(xs[0])
    events = torch.stack([torch.as_tensor(e, dtype=torch.int32, device=dev) for e in evs])
    return (tree_map(lambda *x: torch.stack(x), *xs), comm.CommLedger.stack(leds), events)


def concat_streams(parts: list) -> tuple:
    """Concatenate the (eval_x, ledger, events) streams of consecutive
    chunks along the round axis."""
    if len(parts) == 1:
        return parts[0]
    xs, leds, evs = zip(*parts)
    return (tree_map(lambda *x: torch.cat(x), *xs),
            comm.CommLedger(*(torch.cat([getattr(l, leg) for l in leds])
                              for leg in comm.CommLedger.LEGS)),
            torch.cat(evs))


def run_chunk(spec, batch, basisb, x0, carry, t0: int, steps: int, root_key, *,
              avail=None):
    """Run rounds [t0, t0 + steps) from an explicit carry; returns
    ``(carry, (eval_x stream, CommLedger of per-leg streams, events
    stream))``.  Round t's key is ``fold_in(root_key, t)``, a function of
    the absolute round index only, so a trajectory does not depend on how
    it is cut into chunks.  ``avail`` is an optional ``(steps, n)`` bool
    availability schedule from the fault layer (`faults.FaultPlan.schedule`):
    row i reaches the spec as round t0 + i's `RoundCtx.avail`, on the
    carry's device.  ``None`` (every client reachable) is bitwise an
    all-ones schedule."""
    dev = _device_of(x0)
    steps = int(steps)
    if avail is not None:
        avail = (avail.to(device=dev, dtype=torch.bool) if isinstance(avail, torch.Tensor)
                 else torch.as_tensor(np.asarray(avail, dtype=bool), device=dev))
        if tuple(avail.shape) != (steps, batch.n):
            raise ValueError(
                f"avail schedule must be (steps, n) = ({steps}, {batch.n}), "
                f"got {tuple(avail.shape)}")
    R = VmapReducer(n=batch.n, device=dev)
    env = Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(R, batch, basisb, x0))
    outs = []
    for i, t in enumerate(range(int(t0), int(t0) + steps)):
        rc = RoundCtx(t=t, key=prng.fold_in(root_key, t),
                      avail=None if avail is None else avail[i])
        carry, ys = spec.step(R, env, carry, rc)
        outs.append(ys)
    return carry, _stack_streams(outs)


def carry_leaves(carry) -> list:
    """A carry's tensors in the reference's checkpoint leaf order — that of
    ``jax.tree_util.tree_flatten`` on its carry: tuple order, a
    `comm.CommLedger` leg by leg in field order, dict keys sorted."""
    if isinstance(carry, (tuple, list)):
        return [leaf for elem in carry for leaf in carry_leaves(elem)]
    if isinstance(carry, comm.CommLedger):
        return [getattr(carry, leg) for leg in comm.CommLedger.LEGS]
    return tree_leaves(carry)


def carry_from_leaves(template, leaves):
    """The carry shaped like ``template`` holding ``leaves`` (in
    `carry_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, (tuple, list)):
            return type(node)(build(e) for e in node)
        if isinstance(node, comm.CommLedger):
            return comm.CommLedger(*(next(it) for _ in comm.CommLedger.LEGS))
        return tree_unflatten(node, [next(it) for _ in tree_leaves(node)])

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the carry has")
    return out


# ==========================================================================
# Cohort chunk (repro_torch.core.cohort)
# ==========================================================================
def run_cohort_chunk(spec, batch, basisb, x0, carry, t0: int, steps: int, root_key, *,
                     cidx, frozen: dict, n_global: int):
    """Run ``steps`` cohort rounds from absolute round ``t0``: ``batch`` is
    the cohort's `ClientBatch` (c rows gathered from the
    `client_batch.ClientStore`), ``carry`` the cohort's carry, ``cidx`` the
    slots' global client indices (c,), ``frozen`` the absent clients' fleet
    statistics for the epoch.  The spec sees a `CohortReducer`; round t's
    key is ``fold_in(root_key, t)`` as in `run_chunk`.  Returns ``(carry,
    (eval_x, ledger, events) streams, uploads)``, ``uploads`` the rounds'
    (steps, c) bool upload masks (`note_uploads`)."""
    dev = batch.A.device
    CR = CohortReducer(VmapReducer(n=batch.n, device=dev),
                       idx=torch.as_tensor(cidx, dtype=torch.int32, device=dev),
                       frozen=frozen, n_global=n_global)
    env = Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(CR, batch, basisb, x0))
    outs = []
    for t in range(int(t0), int(t0) + int(steps)):
        carry, ys = spec.step(CR, env, carry, RoundCtx(t=t, key=prng.fold_in(root_key, t)))
        outs.append(ys)
    return carry, _stack_streams(outs), torch.stack(CR.uploads)
