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

The `ShardedReducer` is the reference's `ShardMapReducer` over a
`torch.distributed` client group (`repro_torch.launch.mesh.client_group`):
each rank holds n/ndev clients, draws stay fleet-wide (drawn for all n,
then sliced by `Reducer.shard`), and the drivers take ``sharded=`` and
``exact=`` as the reference's do: ``exact=True`` gathers every uplink leaf
and reduces it as `VmapReducer` does, bitwise; ``exact=False`` follows the
spec's `ReducePlan`.  The drivers take the fleet's batch and basis, run
the rank's slice of them (views) and evaluate the trajectory on the whole;
a sharded carry is held by shard, and `carry_leaves` gathers it to the
one-rank leaves.

The serve programs (`serve_init`, the chunk of `run_chunk`, the cohort
chunk of `run_cohort_chunk`) dispatch through `_Program`, the reference's
`_AotProgram`: a memo by (kind, spec, backend scope, abstract argument
signature) and, when a program cache is active (`repro_torch.core.
progcache`), a program entry naming the kernel libraries the program
launches, which a hit loads before any round.  `warm_chunk_program` and
`warm_cohort_chunk_program` resolve them without running a round, and
`trace_counts` is the reference's retrace audit.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from . import client_batch, comm, prng, progcache
from .pytree import tree_leaves, tree_map, tree_unflatten

#: ops `Reducer.reduce_tree` understands, per leaf
_REDUCE_OPS = ("mean", "sum", "max")
#: collective modes a `ReducePlan` can assign to an uplink payload class
_PLAN_MODES = ("gather", "psum", "pmean")


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """Per-method collective modes for the sharded reducer.

    Read only by ``ShardedReducer(exact=False)``: each uplink leaf is
    classed by its payload rank (leaf shape without the client axis: 0 →
    ``scalar``, 1 → ``vector``, ≥ 2 → ``dense``) and reduced with the mode
    that class names:

      * ``"psum"``   — local sum, then an all-reduce sum (a mean divides by
        n after it); last-ulp summation-order drift;
      * ``"pmean"``  — local mean, then an all-reduce sum divided by the
        rank count (the wire cost of psum, magnitudes kept O(1));
      * ``"gather"`` — the exact dataflow for that class alone (all-gather
        and the one-rank reduction, bitwise).

    ``exact=True`` gathers every leg whatever the plan says.
    ``server_once`` gates `Reducer.once` (server math on rank 0, then a
    broadcast) and ``fuse_uplink`` packs the legs of one (collective,
    dtype) into one collective; both change no bit.  A spec carries its
    plan as the ``MethodSpec.reduce_plan`` class attribute."""

    dense: str = "psum"
    vector: str = "psum"
    scalar: str = "psum"
    server_once: bool = True
    fuse_uplink: bool = True

    def __post_init__(self):
        for f in ("dense", "vector", "scalar"):
            if getattr(self, f) not in _PLAN_MODES:
                raise ValueError(f"ReducePlan.{f} must be one of {_PLAN_MODES}, "
                                 f"got {getattr(self, f)!r}")

    def mode_for(self, payload_ndim: int) -> str:
        if payload_ndim == 0:
            return self.scalar
        if payload_ndim == 1:
            return self.vector
        return self.dense


def _leaf_ops(tree, ops) -> list:
    """``(leaf, op)`` pairs of ``tree`` in `tree_leaves` order; ``ops`` is
    one op, or a tree of ops in which a subtree may take one op for all
    its leaves."""
    if isinstance(ops, str):
        if ops not in _REDUCE_OPS:
            raise ValueError(f"reduce_tree op must be one of {_REDUCE_OPS}, got {ops!r}")
        return [(leaf, ops) for leaf in tree_leaves(tree)]
    return [pair for name in sorted(tree) for pair in _leaf_ops(tree[name], ops[name])]


class Reducer:
    """Cross-client reductions, the interface `MethodSpec.step` sees.

    ``n`` is the fleet's client count; a client-stacked tensor a spec holds
    has a leading ``n_local`` axis (n on one rank, n/ndev on a sharded
    one); fleet-wide draws are made for all n clients and sliced to the
    rank's with `shard`, so every backend sees the same per-client draws.
    The reductions return fleet values, equal on every rank."""

    n: int
    device: torch.device

    @property
    def n_local(self) -> int:
        raise NotImplementedError

    @property
    def n_total(self) -> int:
        """The fleet size: the denominator of per-node bit accounting."""
        return self.n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def max(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a fleet-wide (n, ...) tensor."""
        raise NotImplementedError

    def client_keys(self, key: torch.Tensor) -> torch.Tensor:
        """Per-client PRNG keys of the rank's clients, (n_local, 2) on the
        device: rows of ``split(key, n)``."""
        return self.shard(prng.split(key, self.n, device=self.device))

    def reduce_tree(self, tree, ops="mean"):
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
        sums (the extra output of `Compressor.compress_sum`).  A reducer
        that reduces exactly ignores the sums and reduces `tree` itself;
        ``ShardedReducer(exact=False)`` reduces the sums alone."""
        del local_sums
        return self.tree_mean(tree)

    def once(self, f: Callable, *args):
        """Run server-only math ``f(*args)`` once per fleet."""
        return f(*args)


@dataclasses.dataclass(frozen=True)
class VmapReducer(Reducer):
    """Single-device backend: the client axis is a plain leading axis on
    ``device``, where the fleet-wide draws run."""

    n: int
    device: torch.device = torch.device("cpu")

    @property
    def n_local(self) -> int:
        return self.n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def client_keys(self, key: torch.Tensor) -> torch.Tensor:
        """Per-client PRNG keys, (n, 2) on the device: ``split(key, n)``."""
        return prng.split(key, self.n, device=self.device)


#: the sharded reducers' collectives in this process and the bytes they
#: delivered to it (reset by whoever reads them)
collective_stats = {"collectives": 0, "bytes": 0}

#: the one-rank reductions over a (n, ...) stack: `VmapReducer`'s ops,
#: which is what makes the exact sharded path bitwise
_LOCAL_REDUCE = {
    "mean": lambda g: g.mean(dim=0),
    "sum": lambda g: g.sum(dim=0),
    "max": lambda g: g.amax(dim=0),
}


def _like_layout(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A fresh copy of ``g`` (the fleet's stack of a leaf ``x``, any view)
    laid out in memory as ``x`` is: a reduction over the client axis can
    sum in an order that depends on the layout, so the exact path reduces a
    stack laid out as the one-rank run's."""
    order = sorted(range(x.dim()), key=lambda i: (-x.stride(i), i))
    if x.is_contiguous() or 0 in x.stride() or not x.permute(order).is_contiguous():
        order = list(range(x.dim()))
    out = torch.empty_permuted(g.shape, order, dtype=g.dtype, device=g.device)
    return out.copy_(g)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor as a collective carries it: bool as its bytes."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedReducer(Reducer):
    """The reference's `ShardMapReducer` over a `torch.distributed` client
    group (`repro_torch.launch.mesh.ClientGroup`): rank r holds clients
    ``[r·n_local, (r+1)·n_local)``.

    ``exact=True`` all-gathers every leaf (one collective per dtype, packed
    in leaf order, layout kept) and reduces the fleet's stack as
    `VmapReducer` does: bitwise the one-rank run.  ``exact=False`` reduces
    by the spec's `ReducePlan`: local pre-reductions and an all-reduce (sum,
    or max), less wire traffic, last-ulp drift.  `once` computes on rank 0
    and broadcasts, pure data movement (a broadcast keeps −0.0).  With one
    rank in the group every collective is the identity.  Every collective
    adds one to ``collective_stats["collectives"]`` and the bytes it
    delivered to this rank to ``collective_stats["bytes"]``."""

    n: int
    group: object
    device: torch.device = torch.device("cpu")
    exact: bool = True
    plan: ReducePlan = ReducePlan()
    _once_out: dict = dataclasses.field(default_factory=dict)

    @property
    def ndev(self) -> int:
        return self.group.ndev

    @property
    def n_local(self) -> int:
        return self.n // self.group.ndev

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.group.client_slice]

    def mean(self, x):
        return self.reduce_tree(x, "mean")

    def sum(self, x):
        return self.reduce_tree(x, "sum")

    def max(self, x):
        return self.reduce_tree(x, "max")

    # -------------------------------------------------------- collectives
    def _count(self, t: torch.Tensor) -> None:
        collective_stats["collectives"] += 1
        collective_stats["bytes"] += t.numel() * t.element_size()

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n_local, w) contiguous → (n, w), rows in rank order."""
        import torch.distributed as dist

        w = _wire(x)
        out = torch.empty((self.ndev * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        dist.all_gather_into_tensor(out, w, group=self.group.group)
        self._count(out)
        return _unwire(out, x.dtype)

    def _all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        if self.ndev > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                            group=self.group.group)
            self._count(x)
        return x

    def _broadcast(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        w = _wire(x)
        dist.broadcast(w, src=0, group=self.group.group)
        self._count(w)
        return _unwire(w, x.dtype)

    def fleet_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The fleet's (n, ...) stack of a client-stacked (n_local, ...)
        tensor, rows in client order: the inverse of `shard`."""
        if self.ndev == 1:
            return x
        return self._gather_leaves([x])[0]

    def fleet_tree(self, tree):
        """`fleet_rows` of every leaf of a pytree, one collective a dtype."""
        if self.ndev == 1:
            return tree
        return tree_unflatten(tree, self._gather_leaves(tree_leaves(tree)))

    def _gather_leaves(self, leaves: list) -> list:
        """The fleet's (n, ...) stacks of client-stacked leaves, each laid
        out in memory as its leaf is (`_like_layout`): one all-gather per
        dtype of the leaves packed side by side (in leaf order), or one a
        leaf without ``plan.fuse_uplink``.  Packing and splitting move bits
        without arithmetic."""
        out = [None] * len(leaves)
        groups: dict = {}
        for i, leaf in enumerate(leaves):
            key = leaf.dtype if self.plan.fuse_uplink else i
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            widths = [leaves[i][0].numel() for i in idxs]
            buf = torch.empty((self.n_local, sum(widths)), dtype=leaves[idxs[0]].dtype,
                              device=leaves[idxs[0]].device)
            off = 0
            for i, w in zip(idxs, widths):
                buf[:, off:off + w].view(leaves[i].shape).copy_(leaves[i])
                off += w
            g = self._all_gather(buf)
            del buf
            off = 0
            for i, w in zip(idxs, widths):
                seg = g[:, off:off + w].view((self.n,) + tuple(leaves[i].shape[1:]))
                out[i] = _like_layout(leaves[i], seg)
                off += w
        return out

    def _fused_all_reduce(self, entries: list) -> dict:
        """One all-reduce per (collective, dtype) over ``(index,
        collective, local payload)`` entries, collective one of psum, pmean
        (psum divided by the rank count) and max; returns {index: fleet
        payload}."""
        out, groups = {}, {}
        for i, coll, v in entries:
            key = (coll, v.dtype) if self.plan.fuse_uplink else (coll, v.dtype, i)
            groups.setdefault(key, []).append((i, v))
        for key, items in groups.items():
            coll = key[0]
            flats = [v.reshape(-1) for _, v in items]
            cat = (flats[0] if len(flats) == 1 else torch.cat(flats)).clone()
            red = self._all_reduce(cat, coll)
            if coll == "pmean":
                red = red / self.ndev
            off = 0
            for (i, v), f in zip(items, flats):
                out[i] = red[off:off + f.numel()].reshape(v.shape)
                off += f.numel()
        return out

    # --------------------------------------------------------- reductions
    def reduce_tree(self, tree, ops="mean"):
        pairs = _leaf_ops(tree, ops)
        leaves = [leaf for leaf, _ in pairs]
        if self.ndev == 1:
            return tree_unflatten(tree, [_LOCAL_REDUCE[op](x) for x, op in pairs])
        out = [None] * len(pairs)
        if self.exact:
            for i, ((x, op), g) in enumerate(zip(pairs, self._gather_leaves(leaves))):
                out[i] = _LOCAL_REDUCE[op](g)
            return tree_unflatten(tree, out)
        entries, colls = [], {}
        for i, (x, op) in enumerate(pairs):
            if op == "max":
                colls[i] = "max"
                entries.append((i, "max", x.amax(dim=0)))
                continue
            mode = self.plan.mode_for(x.dim() - 1)
            if mode == "gather":
                out[i] = _LOCAL_REDUCE[op](self._gather_leaves([x])[0])
                continue
            # a pmean of equal-sized local means is the fleet mean; sums,
            # and means under a psum plan, go up as local sums
            colls[i] = "pmean" if (mode == "pmean" and op == "mean") else "psum"
            entries.append((i, colls[i], x.mean(dim=0) if colls[i] == "pmean" else x.sum(dim=0)))
        for i, red in self._fused_all_reduce(entries).items():
            out[i] = red / self.n if (colls[i] == "psum" and pairs[i][1] == "mean") else red
        return tree_unflatten(tree, out)

    def tree_mean_presummed(self, tree, local_sums):
        if self.exact or self.ndev == 1:
            return self.reduce_tree(tree, "mean")
        sums = tree_leaves(local_sums)
        entries = [(i, "pmean", s / self.n_local) if self.plan.mode_for(s.dim()) == "pmean"
                   else (i, "psum", s) for i, s in enumerate(sums)]
        red = self._fused_all_reduce(entries)
        return tree_unflatten(local_sums, [red[i] if coll == "pmean" else red[i] / self.n
                                           for i, coll, _ in entries])

    def once(self, f: Callable, *args):
        if not self.plan.server_once or self.ndev == 1:
            return f(*args)
        sig = (f.__code__, tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                                 else repr(a) for a in args))
        first = self.group.rank == 0
        out = f(*args) if first else None
        spec = self._once_out.get(sig)
        if spec is None:
            # the output's structure, sent once per (function, input shapes)
            import torch.distributed as dist

            msg = [None]
            if first:
                msg = [("tensor", tuple(out.shape), out.dtype) if isinstance(out, torch.Tensor)
                       else ("tuple", [(tuple(o.shape), o.dtype) for o in out])]
            dist.broadcast_object_list(msg, src=0, group=self.group.group)
            spec = self._once_out[sig] = msg[0]
        leaves = ([out] if spec[0] == "tensor" else list(out)) if first else [
            torch.empty(shape, dtype=dtype, device=self.device)
            for shape, dtype in ([spec[1:]] if spec[0] == "tensor" else spec[1])]
        leaves = [self._broadcast(x.contiguous()) for x in leaves]
        return leaves[0] if spec[0] == "tensor" else tuple(leaves)


class CohortReducer:
    """Reducer view of a sampled cohort standing in for the whole fleet.

    Wraps the cohort's reducer ``inner`` (a `VmapReducer`, or a
    `ShardedReducer` over the cohort axis) so a spec's `step` runs
    unchanged: ``n``, ``n_local``, ``device``, `shard`, `client_keys` and
    `once` are the cohort axis's; ``n_total`` is the fleet's size, so bills
    and participation stay fleet-denominated; ``idx`` holds each of the
    rank's slots' global client index, and ``real`` (None: every slot)
    marks the slots that hold a client, when the capacity was padded to a
    multiple of the rank count: a padded slot never reduces.  `reduce_tree`
    adds the host's ``frozen`` sums of the absent clients' state to a
    ``mean`` (and takes the max with their max for ``max``); a ``mean``
    without a frozen entry is delta-style and divides the cohort's sum
    alone by ``n_total``.  Bare `mean` and `max` raise: an unnamed fleet
    reduction cannot be matched to a frozen statistic.  ``uploads`` collects
    each round's upload mask over the rank's slots (`note_uploads`), so
    the engine can report who took part."""

    is_cohort = True

    def __init__(self, inner: Reducer, idx: torch.Tensor, frozen: dict, n_global: int,
                 real: Optional[torch.Tensor] = None):
        self.inner = inner
        self.idx = idx
        self.real = real
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

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner.shard(x)

    def client_keys(self, key: torch.Tensor) -> torch.Tensor:
        return self.inner.client_keys(key)

    def once(self, f: Callable, *args):
        return self.inner.once(f, *args)

    def _mask(self, x: torch.Tensor, fill) -> torch.Tensor:
        if self.real is None:
            return x
        r = self.real.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(r, x, torch.as_tensor(fill, dtype=x.dtype, device=x.device))

    # ---- fleet reductions --------------------------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Fleet sum of a quantity absent clients hold at 0 (participation
        masks, bit counts)."""
        return self.inner.sum(self._mask(x, 0))

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
            {name: self._mask(x, -torch.inf if ops_d[name] == "max" else 0)
             for name, x in tree.items()},
            {name: "max" if ops_d[name] == "max" else "sum" for name in tree})
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


def participation(R: Reducer, key: torch.Tensor, tau: int,
                  avail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli(τ/n) participation mask of the rank's clients, with the
    force-one-client fallback, from the split keys (mask, fallback index)
    of ``key``: drawn over the whole fleet, then sliced by `Reducer.shard`.
    τ < 1 raises ``ValueError``; τ ≥ n is full participation (every
    uniform is below 1, so nothing is drawn).

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
        return R.shard(drawn | forced), event.to(torch.int32)
    avail = avail.to(device=dev, dtype=torch.bool)
    n_avail = avail.sum()
    surviving = drawn & avail
    n_surv = surviving.sum()
    pick = avail & (torch.cumsum(avail, 0) == idx % torch.clamp(n_avail, min=1) + 1)
    need_force = (n_surv == 0) & (n_avail > 0)
    part = surviving | (need_force & pick)
    event = (EVENT_DEGRADED * ((n_surv < drawn.sum()) & (n_surv < tau))
             + EVENT_FORCED * need_force + EVENT_ALL_DOWN * (n_avail == 0))
    return R.shard(part), event.to(torch.int32)


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
    if R.real is not None:
        drawn = drawn & R.real
    n_surv = R.sum(drawn.to(torch.int32))
    need = n_surv == 0
    # the fallback: the real slot of least global index, over every rank
    # (−max(−idx): the reducer carries max, not min)
    idx = R.idx if R.real is None else torch.where(R.real, R.idx, torch.iinfo(R.idx.dtype).max)
    gmin = -R.inner.reduce_tree({"i": -idx}, "max")["i"]
    part = drawn | (need & (R.idx == gmin))
    if R.real is not None:
        part = part & R.real
    event = torch.where(need, EVENT_FORCED, EVENT_NONE)
    note_uploads(R, part)
    return part, event.to(torch.int32)


def note_uploads(R, mask: torch.Tensor) -> None:
    """Record a round's upload mask (participants, or FedNL-BAG's
    reporters) on a `CohortReducer`; other reducers keep nothing."""
    if getattr(R, "is_cohort", False):
        R.uploads.append(mask)


def xi_mask(R: Reducer, key: torch.Tensor, p: float) -> torch.Tensor:
    """Per-client ξ ~ Bernoulli(p) gradient-refresh mask of the rank's
    clients, (n_local,) bool, drawn over the fleet."""
    if p >= 1.0:
        return torch.ones(R.n_local, dtype=torch.bool, device=R.device)
    return R.shard(prng.bernoulli(key, p, (R.n,), device=R.device))


def xi_scalar(key: torch.Tensor, p: float, *, device=None) -> torch.Tensor:
    """Fleet-wide scalar ξ (BL1's single gradient-leg switch), drawn on the
    host and placed on ``device``."""
    if p >= 1.0:
        return torch.tensor(True, device=device)
    return prng.bernoulli(key, p, (1,))[0].to(device)


def client_keys_for(R: Reducer, comp, key: torch.Tensor):
    """``R.client_keys(key)`` for a compressor that draws, None for one
    that does not."""
    return None if comp.deterministic else R.client_keys(key)


def downlink_broadcast(R: Reducer, comp, key: torch.Tensor, z: torch.Tensor,
                       x_target: torch.Tensor, eta: float, part: torch.Tensor):
    """Compressed model-stream downlink to participating clients:
    z_i ← z_i + η·C_i(x − z_i).  Returns (z_new, down_bits_fleet_sum): the
    reference returns the sum's per-node share, which the port's ledger
    takes with `comm.CommLedger.add_fleet_sums`."""
    v, counts = comp.compress(client_keys_for(R, comp, key), x_target[None, :] - z)
    vbits = comm.price(comp.wire, counts)
    z_n = torch.where(part[:, None], z + eta * v, z)
    return z_n, R.sum(torch.where(part, vbits, 0.0))


def global_grad(R: Reducer, batch, x: torch.Tensor) -> torch.Tensor:
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


def coeff_layout(R: Reducer, batch, basisb, x0: torch.Tensor,
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


def make_reducer(spec, n: int, device, *, sharded: bool = False, exact: bool = True) -> Reducer:
    """The round engine's reducer for a fleet of ``n`` clients on
    ``device``: a `VmapReducer`, or with ``sharded`` a `ShardedReducer` over
    the client group of this process's world
    (`repro_torch.launch.mesh.client_group`) under the spec's
    `ReducePlan`.  Every rank of the world must call it."""
    device = torch.device(device)
    if not sharded:
        return VmapReducer(n=n, device=device)
    from ..launch import mesh

    return ShardedReducer(n=n, group=mesh.client_group(n, device), device=device,
                          exact=exact, plan=getattr(spec, "reduce_plan", ReducePlan()))


def is_sharded(R) -> bool:
    return isinstance(R, ShardedReducer)


def local_problem(R: Reducer, spec, batch, basisb):
    """The rank's slice of the fleet's batch and basis (views; a basis the
    spec declares ``basis_replicated`` is whole on every rank)."""
    if not is_sharded(R):
        return batch, basisb
    sl = R.group.client_slice
    lbatch = client_batch.shard_batch(batch, sl)
    if basisb is None or getattr(spec, "basis_replicated", False):
        return lbatch, basisb
    return lbatch, client_batch.shard_basis(basisb, sl)


def _share(R: Reducer, obj):
    """``obj`` from rank 0 on every rank of the world (the ranks off a
    sharded reducer's group compute nothing and receive it here)."""
    return R.group.share(obj) if is_sharded(R) else obj


def run_rounds(spec, batch, basisb, x0, f_star, steps: int, *, seed: int = 0,
               sharded: bool = False, exact: bool = True, stream=None):
    """Run `steps` rounds of `spec` and return ``(evals, ledger_streams)``:
    ``evals`` is the dict of (steps,) streams from ``spec.eval_streams``
    (always holding ``"gap"``), the ledger holds one (steps,) cumulative
    bit stream per leg, recorded at the start of each round as the
    reference's scan does.  ``x0`` is a tensor or a parameter pytree; the
    trajectory reaches ``eval_streams`` stacked leaf by leaf, (steps, ...).
    Round t's key is row t of ``split(PRNGKey(seed), steps)``, as the
    reference's batch driver splits them (`repro.core.batched._run`).
    ``stream`` is an optional `StreamHook` (it fires on the ranks that
    hold clients).

    ``sharded`` runs the `ShardedReducer` over this world's client group:
    ``batch`` and ``basisb`` are the fleet's, each rank runs its slice, the
    trajectory is evaluated on the fleet's batch (as the reference
    evaluates it outside its sharded program), and every rank returns the
    same streams.  ``exact`` (the default) is
    bitwise the one-rank run; ``exact=False`` reduces by the spec's
    `ReducePlan`."""
    if steps < 1:
        raise ValueError(f"run_rounds needs steps >= 1, got {steps}")
    R = make_reducer(spec, batch.n, tree_leaves(x0)[0].device, sharded=sharded, exact=exact)
    if is_sharded(R) and not R.group.active:
        return _share(R, None)
    lbatch, lbasis = local_problem(R, spec, batch, basisb)
    env = Env(batch=lbatch, basisb=lbasis, x0=x0,
              extra=spec.prepare(R, lbatch, lbasis, x0))
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
    return _share(R, (evals, comm.CommLedger.stack(leds)))


# ==========================================================================
# Programs: cache-aware dispatch of the serve programs, and the retrace audit
# ==========================================================================
# Retrace audit.  The port runs its rounds eagerly, so a "trace" is a
# program's resolution: on a cache miss, or on its first dispatch when no
# cache is active.  The invariant is the reference's: one per (kind, spec,
# shapes) per process and zero across chunk and epoch boundaries; a cache
# hit counts as a hit, not a trace.  `carry_client_flags`' evaluations of
# the init on meta tensors count under "init/shape_eval".
_TRACE_COUNTS: collections.Counter = collections.Counter()


def trace_counts() -> dict:
    """{program kind: traces} since the last reset.  Kinds: "init",
    "chunk", "cohort_chunk" and "init/shape_eval"."""
    return dict(_TRACE_COUNTS)


def reset_trace_audit() -> None:
    _TRACE_COUNTS.clear()


# resolved programs by (cache serial or None, entry name, spec, scope,
# signature): module-level, so the memo outlives the per-dispatch `_Program`
_PROGRAMS: dict = {}


def clear_aot_memo() -> None:
    """Drop the program resolutions of this process (tests use it to send
    the next dispatch back through the on-disk cache).  The loaded kernel
    libraries and their bound entry points stay for the life of the
    process."""
    _PROGRAMS.clear()


def _abstract_sig(o):
    """A hashable shape-and-type signature of a program's arguments:
    tensors by shape, dtype and device type; dataclasses (`ClientBatch`,
    `BatchedBasis`, `CommLedger`) by class and fields, their static fields
    (λ, a basis's kind and ranks) by value; containers recursively."""
    if isinstance(o, torch.Tensor):
        return ("T", tuple(o.shape), str(o.dtype), o.device.type)
    if o is None or isinstance(o, (bool, int, str)):
        return o
    if isinstance(o, float):
        return float.hex(o)
    if isinstance(o, (tuple, list)):
        return (type(o).__name__,) + tuple(_abstract_sig(v) for v in o)
    if isinstance(o, dict):
        return ("dict",) + tuple((k, _abstract_sig(o[k])) for k in sorted(o))
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return (type(o).__qualname__,) + tuple(
            (f.name, _abstract_sig(getattr(o, f.name))) for f in dataclasses.fields(o))
    return type(o).__qualname__


def _scope(R, *extra) -> tuple:
    """The backend scope of a program: ``("vmap", n, device type)`` or
    ``("sharded", world size, n, exact)``, then ``extra``."""
    if is_sharded(R):
        return ("sharded", R.group.world_size, R.n, R.exact) + extra
    return ("vmap", R.n, R.device.type) + extra


def _load_libraries(path: str) -> list:
    """A program entry's payload: load the kernel libraries it names."""
    with open(path) as f:
        libs = json.load(f)
    if not isinstance(libs, list) or not all(isinstance(e, dict) and
                                             isinstance(e.get("library"), str) for e in libs):
        raise ValueError(f"{path}: not a list of kernel-library entries")
    for e in libs:
        _build.load(e["library"])
    return libs


@dataclasses.dataclass
class _Pending:
    """A program whose entry missed: its first call runs it and stores the
    entry from the libraries that call launched."""

    cache: progcache.ProgramCache
    key: str
    aux: dict


class _Program:
    """One serve program behind cache-aware dispatch (the reference's
    `_AotProgram`).

    ``fn(*args)`` is the program's eager body and ``sig(*args)`` the part
    of its arguments its signature covers (shapes, not values: never the
    round index or the key).  With no active cache, a call is ``fn`` plus
    one memo lookup (the first counts a trace).  With a cache, the first
    resolution of a signature reads the program entry: a hit loads the
    kernel libraries it names, before any round; a miss counts a trace,
    and the next call runs the program and stores its entry — the
    libraries it launched — before returning, so before the serve loop
    writes a checkpoint.  `resolve` is the half that never runs the
    program (the serve loop warms through it before restore)."""

    def __init__(self, name: str, kind: str, spec, scope: tuple, fn: Callable,
                 sig: Callable):
        self.name, self.kind = name, kind
        self.spec, self.scope = spec, scope
        self.fn, self.sig = fn, sig

    def _memo_key(self, cache, sig) -> tuple:
        spec = self.spec
        try:
            hash(spec)
        except TypeError:                     # a spec with an unhashable field
            spec = ("id", id(spec))
        return (None if cache is None else cache.serial, self.name, spec, self.scope, sig)

    def resolve(self, *args):
        """The memo key and state for these arguments (True: resolved;
        a `_Pending`: missed, the next call stores).  Never runs ``fn``."""
        cache = progcache.active()
        sig = _abstract_sig(self.sig(*args))
        memo = self._memo_key(cache, sig)
        state = _PROGRAMS.get(memo)
        if state is not None:
            return memo, state
        if cache is None:
            _TRACE_COUNTS[self.kind] += 1
            state = True
        else:
            key = progcache.entry_key((self.name, progcache.fingerprint(self.spec),
                                       progcache.fingerprint(self.scope), repr(sig)),
                                      cache.backend)
            _, why = cache.lookup(self.name, key, _load_libraries)
            state = True
            if why != "hit":
                _TRACE_COUNTS[self.kind] += 1
                state = _Pending(cache, key, {"scope": [str(s) for s in self.scope]})
        _PROGRAMS[memo] = state
        return memo, state

    def __call__(self, *args):
        memo, state = self.resolve(*args)
        if state is True:
            return self.fn(*args)
        with _build.recording() as used:
            out = self.fn(*args)
        libs = [{"library": lib, "entry": _build.entry_name(lib)} for lib in sorted(used)]
        state.cache.store(self.name, state.key, json.dumps(libs).encode(), state.aux)
        _PROGRAMS[memo] = True
        return out


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


def _init_body(spec, R, batch, basisb, x0):
    env = Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(R, batch, basisb, x0))
    return spec.init(R, env)


def _init_program(spec, R) -> _Program:
    return _Program("serve_init", "init", spec, _scope(R), _init_body,
                    lambda spec, R, batch, basisb, x0: (batch, basisb, x0))


def serve_init(spec, R, batch, basisb, x0):
    """The round-0 carry: ``spec.init`` after ``spec.prepare``, the init
    the stacked driver and the cohort engine's fleet init share, through
    the ``serve_init`` program (`_Program`)."""
    return _init_program(spec, R)(spec, R, batch, basisb, x0)


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
        _TRACE_COUNTS["init/shape_eval"] += 1
        carry = _init_body(spec, VmapReducer(n=nn, device=torch.device("meta")), b, bb, xm)
        return [_elem_shapes(e) for e in carry]

    s1, s2 = shapes_at(n), shapes_at(2 * n)
    return tuple(tuple(a != b for a, b in zip(e1, e2)) for e1, e2 in zip(s1, s2))


def init_serve_carry(spec, batch, basisb, x0, *, sharded: bool = False, exact: bool = True):
    """The round-0 carry of the chunked driver on ``x0``'s device.  With
    ``sharded`` it is the rank's shard of the carry (its client-stacked
    leaves hold the rank's rows; `carry_leaves` gathers them), and None on
    a rank off the client group."""
    R = make_reducer(spec, batch.n, _device_of(x0), sharded=sharded, exact=exact)
    if is_sharded(R) and not R.group.active:
        return None
    lbatch, lbasis = local_problem(R, spec, batch, basisb)
    return serve_init(spec, R, lbatch, lbasis, x0)


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
              avail=None, sharded: bool = False, exact: bool = True):
    """Run rounds [t0, t0 + steps) from an explicit carry; returns
    ``(carry, (eval_x stream, CommLedger of per-leg streams, events
    stream))``.  Round t's key is ``fold_in(root_key, t)``, a function of
    the absolute round index only, so a trajectory does not depend on how
    it is cut into chunks.  ``avail`` is an optional ``(steps, n)`` bool
    availability schedule from the fault layer (`faults.FaultPlan.schedule`):
    row i reaches the spec as round t0 + i's `RoundCtx.avail`, on the
    carry's device.  ``None`` (every client reachable) is bitwise an
    all-ones schedule.

    ``sharded``/``exact`` are `run_rounds`'s: ``batch`` and ``basisb`` are
    the fleet's, ``carry`` the rank's shard (`init_serve_carry`); a rank
    off the client group passes its None carry through and receives the
    streams."""
    dev = _device_of(x0)
    steps = int(steps)
    if avail is not None:
        avail = (avail.to(device=dev, dtype=torch.bool) if isinstance(avail, torch.Tensor)
                 else torch.as_tensor(np.asarray(avail, dtype=bool), device=dev))
        if tuple(avail.shape) != (steps, batch.n):
            raise ValueError(
                f"avail schedule must be (steps, n) = ({steps}, {batch.n}), "
                f"got {tuple(avail.shape)}")
    R = make_reducer(spec, batch.n, dev, sharded=sharded, exact=exact)
    if is_sharded(R) and not R.group.active:
        return carry, _share(R, None)
    lbatch, lbasis = local_problem(R, spec, batch, basisb)
    carry, streams = _chunk_program(spec, R)(spec, R, lbatch, lbasis, x0, carry, int(t0),
                                             steps, root_key, avail)
    return carry, _share(R, streams)


def _chunk_body(spec, R, batch, basisb, x0, carry, t0: int, steps: int, root_key, avail):
    env = Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(R, batch, basisb, x0))
    outs = []
    for i, t in enumerate(range(t0, t0 + steps)):
        rc = RoundCtx(t=t, key=prng.fold_in(root_key, t),
                      avail=None if avail is None else avail[i])
        carry, ys = spec.step(R, env, carry, rc)
        outs.append(ys)
    return carry, _stack_streams(outs)


def _chunk_program(spec, R) -> _Program:
    # the signature holds the chunk's length, not its first round or key
    return _Program("serve_chunk", "chunk", spec, _scope(R), _chunk_body,
                    lambda spec, R, batch, basisb, x0, carry, t0, steps, key, avail:
                    (batch, basisb, x0, carry, steps))


def warm_chunk_program(spec, batch, basisb, x0, carry, steps: int, *,
                       sharded: bool = False, exact: bool = True) -> bool:
    """Resolve the serve (init, chunk) programs of this cell through the
    active program cache — on a hit its kernel libraries load — without
    running a round or touching ``carry``, a template at the dispatch
    shapes (`init_serve_carry`'s output).  The serve loop calls this before
    checkpoint restore, so a warm restart builds nothing before its first
    round.  Returns False (and does nothing) when no cache is active.  (The
    reference's ``root_key`` argument is gone: a key's value keys no
    program.)"""
    if progcache.active() is None:
        return False
    R = make_reducer(spec, batch.n, _device_of(x0), sharded=sharded, exact=exact)
    if is_sharded(R) and not R.group.active:
        return True
    lbatch, lbasis = local_problem(R, spec, batch, basisb)
    _init_program(spec, R).resolve(spec, R, lbatch, lbasis, x0)
    _chunk_program(spec, R).resolve(spec, R, lbatch, lbasis, x0, carry, 0, int(steps),
                                    None, None)
    return True


def _flat_flags(flags) -> list:
    return [f for elem in flags for f in elem]


def carry_leaves(carry, R: Optional[Reducer] = None, flags=None) -> list:
    """A carry's tensors in the reference's checkpoint leaf order — that of
    ``jax.tree_util.tree_flatten`` on its carry: tuple order, a
    `comm.CommLedger` leg by leg in field order, dict keys sorted.

    With a sharded reducer ``R`` and the carry's `carry_client_flags`, the
    client-stacked leaves are gathered to the fleet's (one collective a
    dtype), so the leaves are those of the one-rank run's carry."""
    if isinstance(carry, (tuple, list)):
        leaves = [leaf for elem in carry for leaf in carry_leaves(elem)]
    elif isinstance(carry, comm.CommLedger):
        leaves = [getattr(carry, leg) for leg in comm.CommLedger.LEGS]
    else:
        leaves = tree_leaves(carry)
    if R is None or not is_sharded(R) or R.ndev == 1:
        return leaves
    cl = [leaf for leaf, f in zip(leaves, _flat_flags(flags)) if f]
    it = iter(R.fleet_tree({f"{i:06d}": x for i, x in enumerate(cl)}).values())
    return [next(it) if f else leaf for leaf, f in zip(leaves, _flat_flags(flags))]


def shard_carry(carry, R: Reducer, flags):
    """The rank's shard of a fleet carry (a restored checkpoint): its
    client-stacked leaves cut to the rank's rows, as fresh tensors."""
    if not is_sharded(R) or R.ndev == 1:
        return carry
    leaves = carry_leaves(carry)
    return carry_from_leaves(carry, [R.shard(leaf).clone() if f else leaf
                                     for leaf, f in zip(leaves, _flat_flags(flags))])


def fleet_template(carry, R: Reducer, flags):
    """A carry shaped as the fleet's, from the rank's shard (uninitialized
    client-stacked leaves): the template a checkpoint is checked against."""
    if not is_sharded(R) or R.ndev == 1:
        return carry
    leaves = carry_leaves(carry)
    return carry_from_leaves(carry, [
        torch.empty((R.n,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
        if f else leaf for leaf, f in zip(leaves, _flat_flags(flags))])


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
                     cidx, frozen: dict, n_global: int, real=None, sharded: bool = False,
                     exact: bool = True, cap: Optional[int] = None):
    """Run ``steps`` cohort rounds from absolute round ``t0``: ``batch`` is
    the cohort's `ClientBatch` (c rows gathered from the
    `client_batch.ClientStore`), ``carry`` the cohort's carry, ``cidx`` the
    slots' global client indices (c,), ``frozen`` the absent clients' fleet
    statistics for the epoch.  The spec sees a `CohortReducer`; round t's
    key is ``fold_in(root_key, t)`` as in `run_chunk`.  Returns ``(carry,
    (eval_x, ledger, events) streams, uploads)``, ``uploads`` the rounds'
    (steps, c) bool upload masks (`note_uploads`).

    ``sharded`` splits the cohort axis of ``cap`` slots (a multiple of the
    rank count, padded past the cohort; ``real`` marks the slots that hold
    a client) over the ranks: ``batch``, ``carry``, ``cidx`` and ``real``
    are then the rank's slots, and ``uploads`` is gathered to all ``cap``
    slots."""
    R, idx, real = _cohort_args(spec, batch, cidx, real, sharded, exact, cap)
    carry, streams, ups = _cohort_program(spec, R, n_global)(
        spec, R, batch, basisb, x0, carry, int(t0), int(steps), root_key, idx, frozen,
        int(n_global), real)
    if is_sharded(R):
        ups = R.fleet_rows(ups.T.contiguous()).T
    return carry, streams, ups


def _cohort_args(spec, batch, cidx, real, sharded: bool, exact: bool, cap):
    dev = batch.A.device
    R = make_reducer(spec, batch.n if cap is None else int(cap), dev, sharded=sharded,
                     exact=exact)
    return (R, torch.as_tensor(cidx, dtype=torch.int32, device=dev),
            None if real is None else torch.as_tensor(real, device=dev))


def _cohort_body(spec, R, batch, basisb, x0, carry, t0: int, steps: int, root_key, cidx,
                 frozen: dict, n_global: int, real):
    CR = CohortReducer(R, idx=cidx, frozen=frozen, n_global=n_global, real=real)
    env = Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(CR, batch, basisb, x0))
    outs = []
    for t in range(t0, t0 + steps):
        carry, ys = spec.step(CR, env, carry, RoundCtx(t=t, key=prng.fold_in(root_key, t)))
        outs.append(ys)
    return carry, _stack_streams(outs), torch.stack(CR.uploads)


def _cohort_program(spec, R, n_global: int) -> _Program:
    return _Program("cohort_chunk", "cohort_chunk", spec, _scope(R, int(n_global)),
                    _cohort_body,
                    lambda spec, R, batch, basisb, x0, carry, t0, steps, key, cidx, frozen,
                    n_global, real: (batch, basisb, x0, carry, steps, cidx, frozen, real))


def warm_cohort_chunk_program(spec, batch, basisb, x0, carry, steps: int, *,
                              cidx, frozen: dict, n_global: int, real=None,
                              sharded: bool = False, exact: bool = True,
                              cap: Optional[int] = None) -> bool:
    """`warm_chunk_program` for the cohort chunk program: every argument a
    template at `run_cohort_chunk`'s dispatch shapes
    (`repro_torch.core.cohort.CohortEngine.warm_programs` builds them
    before any epoch is gathered).  Returns False when no cache is
    active."""
    if progcache.active() is None:
        return False
    R, idx, real = _cohort_args(spec, batch, cidx, real, sharded, exact, cap)
    _cohort_program(spec, R, n_global).resolve(spec, R, batch, basisb, x0, carry, 0,
                                               int(steps), None, idx, frozen,
                                               int(n_global), real)
    return True
