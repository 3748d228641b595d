"""Cohort-streaming engine: federated rounds whose cost does not grow with
the fleet — port of `repro.core.cohort`.

The stacked engine (`rounds.run_chunk`) holds every client's data and
shift state on the device.  The partial-participation methods (BL2/BL3,
Alg. 2–3) and the Bernoulli-lazy uplink (FedNL-BAG) only touch a sampled
cohort, so this engine streams instead:

  * the whole fleet lives on the host in a `client_batch.ClientStore`
    (data A/b and the client-stacked carry leaves, float64 numpy);
  * each **epoch** (``rounds_per_cohort`` consecutive rounds) draws a
    cohort of ``cohort`` clients from numpy's Philox keyed on (root key,
    epoch), a function of the absolute epoch only, so the schedule does
    not depend on how rounds are cut into chunks;
  * only the cohort's rows reach the device, where `rounds.run_cohort_chunk`
    runs the epoch's rounds.  Its data (A, b) is read-only, so on a CUDA
    device the next epoch's data is gathered on a prefetch thread into
    pinned host memory and copied on a CUDA stream of its own while the
    current epoch computes, and the compute stream waits on the copy's
    event before it reads.  Its carry rows, its global indices and the
    frozen statistics are copied synchronously when the epoch loads: a
    client in two consecutive cohorts has its final rows only after the
    earlier epoch unloads;
  * absent clients' state stays frozen (Alg. 2–3); their share of each
    fleet aggregate (`MethodSpec.cohort_aggregates`) is kept on the host
    in float64: each epoch subtracts the cohort's epoch-start rows from the
    fleet totals to give the ``frozen`` statistics, and adds the updated
    rows back when the epoch ends.  A round therefore costs O(cohort), not
    O(n).

When ``cohort >= n`` the engine runs in **full mode**: the fleet is
gathered once and the rounds go to the stacked `rounds.run_chunk`, so that
configuration is the stacked engine bit for bit.

`checkpoint_payload` and `restore` carry a run across a process (the
carry's leaves and the host state: store rows, aggregate totals, the
epoch's frozen statistics); the service loop
(`repro_torch.launch.fed_serve`) writes them as the ckpt@2 ``host_state``
payload (`repro_torch.exp.artifacts.save_checkpoint`).

``sharded=True`` (the ``cohort+sharded`` backend) splits each cohort over
the ranks of the process's `torch.distributed` world: the capacity is
padded to a multiple of the rank count (padded slots hold client 0's rows
and never reduce), each rank gathers and runs its slots under a
`rounds.ShardedReducer`, and at unload the cohort's rows are gathered to
every rank, so every rank's `ClientStore` stays the same store.
Checkpoints keep the one-rank layout: the carry's cohort rows without
padding.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..launch import mesh
from . import client_batch, prng, rounds

#: fold_in salt separating the cohort sampler's stream from the per-round
#: keys (rounds use fold_in(root_key, t) with small t)
COHORT_SALT = 0x0C0407


def standard_basisb(d: int, n: int) -> client_batch.BatchedBasis:
    """A standard-basis `BatchedBasis` for n clients: the basis of the
    store-backed problems (nothing per client to stream)."""
    return client_batch.BatchedBasis(kind="standard", d=d, rs=(d,) * n)


# ==========================================================================
# Host-side (numpy) fleet evaluation, slab by slab
# ==========================================================================
def store_loss(store: client_batch.ClientStore, x, slab: int = 8192) -> float:
    """Global logistic loss over the full fleet, accumulated slab by slab
    in float64 on the host: the mean over clients of the mean over samples
    of logaddexp(0, −b·Ax), plus λ/2‖x‖²."""
    x = np.asarray(x, np.float64)
    tot = 0.0
    for lo in range(0, store.n, slab):
        A = np.asarray(store.A[lo:lo + slab], np.float64)
        b = np.asarray(store.b[lo:lo + slab], np.float64)
        z = np.einsum("nmd,d->nm", A, x) * b
        tot += float(np.sum(np.mean(np.logaddexp(0.0, -z), axis=1)))
    return tot / store.n + 0.5 * store.lam * float(np.dot(x, x))


def store_newton_solve(store: client_batch.ClientStore, x0, iters: int = 20,
                       slab: int = 8192) -> np.ndarray:
    """Reference optimum of the store's fleet objective by undamped Newton,
    the gradient and Hessian accumulated slab by slab on the host."""
    x = np.asarray(x0, np.float64).copy()
    d = store.d
    for _ in range(int(iters)):
        g = np.zeros(d)
        H = np.zeros((d, d))
        for lo in range(0, store.n, slab):
            A = np.asarray(store.A[lo:lo + slab], np.float64)
            b = np.asarray(store.b[lo:lo + slab], np.float64)
            z = np.einsum("nmd,d->nm", A, x) * b
            s = 1.0 / (1.0 + np.exp(z))          # σ(−z)
            m = A.shape[1]
            g += np.einsum("nmd,nm->d", A, -b * s) / m
            H += np.einsum("nmd,nm,nme->de", A, s * (1.0 - s), A) / m
        g = g / store.n + store.lam * x
        H = H / store.n + store.lam * np.eye(d)
        x = x - np.linalg.solve(H, g)
    return x


# ==========================================================================
# Cohort sampling: counter-based, chunk-boundary invariant
# ==========================================================================
def sampler_seed(root_key: torch.Tensor) -> int:
    """The sampler's 64-bit Philox seed: the words of ``fold_in(root_key,
    COHORT_SALT)``, high word first."""
    hi, lo = prng.fold_in(root_key.cpu(), COHORT_SALT).tolist()
    return (hi << 32) | lo


def cohort_indices(seed64: int, n: int, c: int, epoch: int) -> np.ndarray:
    """An epoch's sorted cohort of c unique clients of n: a function of
    (seed, epoch) only — numpy's Philox keyed by ``(seed64 << 64) +
    epoch``, as the reference draws it."""
    rng = np.random.Generator(np.random.Philox(key=(seed64 << 64) + int(epoch)))
    if c * 8 <= n:
        # rejection: the first c distinct values in draw order (an unbiased
        # sample without replacement in O(c) draws)
        chosen = np.empty(0, np.int64)
        while chosen.size < c:
            cand = rng.integers(0, n, size=2 * c, dtype=np.int64)
            merged = np.concatenate([chosen, cand])
            _uniq, first = np.unique(merged, return_index=True)
            chosen = merged[np.sort(first)]
        idx = chosen[:c]
    else:
        idx = rng.permutation(n)[:c]
    return np.sort(idx).astype(np.int64)


def capacity(cohort: int, n: int) -> int:
    """Slots a sharded cohort of ``cohort`` clients (of a fleet of n)
    runs in: the cohort padded to a multiple of the world's rank count (the
    whole fleet, unpadded, when the cohort covers it)."""
    if cohort >= n:
        return n
    size = mesh.world()[1]
    return -(-cohort // size) * size


def _slab_extras(spec, R, batch, basisb, x0, carry) -> dict:
    """`MethodSpec.cohort_init_extras` for one init slab."""
    env = rounds.Env(batch=batch, basisb=basisb, x0=x0, extra=spec.prepare(R, batch, basisb, x0))
    return spec.cohort_init_extras(R, env, carry)


class CohortEngine:
    """Streaming round driver over a `client_batch.ClientStore`.

    Args:
      spec: a ``supports_cohort`` `MethodSpec` (BL2, BL3, FedNL-BAG).
      store: the host-resident fleet; its ``state`` is (re)initialized.
      x0: the initial iterate (d,), a tensor on the device the rounds run
        on.
      cohort: clients sampled an epoch; ``cohort >= store.n`` is full mode.
      rounds_per_cohort: rounds a cohort stays resident (the epoch).
      root_key: the run's root key (`prng.PRNGKey`): round t's key is
        ``fold_in(root_key, t)``, the sampler's ``fold_in(root_key,
        COHORT_SALT)``.
      basis: ``"standard"`` or None (BL3): store-backed problems use
        convention bases only.
      sharded: split each cohort over the ranks of the process's world
        (``cohort+sharded``); every rank of the world constructs the
        engine and calls it alike.
      exact: the sharded reducer's collectives (`rounds.ShardedReducer`).
      slab: clients a fleet-init slab holds on the device.
      prefetch: gather (and on a CUDA device, copy) the next epoch's data
        behind the current epoch's rounds; moves data only, changes no bit.

    After the fleet init (which moves every client's data once, slab by
    slab), ``metrics["h2d_bytes"]`` counts every host-to-device copy the
    engine makes (data, carry rows, indices, frozen statistics, restored
    carries) where it makes it, ``metrics["d2h_bytes"]`` the carry rows it
    copies back; ``uploads`` holds, for each round of the last `run_chunk` call,
    the global indices of the clients that uploaded (BL2/BL3's
    participants, FedNL-BAG's reporters; None in full mode).
    """

    def __init__(self, spec, store: client_batch.ClientStore, x0: torch.Tensor, *,
                 cohort: int, rounds_per_cohort: int, root_key,
                 basis: Optional[str] = "standard", sharded: bool = False,
                 exact: bool = True, slab: int = 4096, prefetch: bool = True):
        if rounds_per_cohort < 1:
            raise ValueError(f"rounds_per_cohort must be >= 1, got {rounds_per_cohort}")
        if cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {cohort}")
        self.spec = spec
        self.store = store
        self.device = x0.device
        self.x0 = x0
        self.n = store.n
        self.d = int(self.x0.shape[0])
        self.rpc = int(rounds_per_cohort)
        self.root_key = root_key.cpu()
        self.slab = int(slab)
        self.full = int(cohort) >= self.n
        self.cohort = self.n if self.full else int(cohort)
        self.sharded = bool(sharded)
        self.exact = bool(exact)
        if self.sharded:
            mesh.init_from_env(self.device)
        # the device axis: the cohort's slots, padded when sharded
        self.cap = capacity(self.cohort, self.n) if self.sharded else self.cohort
        self._R = rounds.make_reducer(spec, self.cap, self.device, sharded=self.sharded,
                                      exact=self.exact)
        self._slots = (self._R.group.client_slice if self.sharded
                       else slice(0, self.cap))
        if not self.full and not getattr(spec, "supports_cohort", False):
            raise ValueError(
                f"{type(spec).__name__} is not cohort-capable (MethodSpec.supports_cohort "
                "is False): absent clients' fleet contributions cannot be frozen; run it "
                "stacked or with cohort >= n")
        if basis not in (None, "standard"):
            raise ValueError(
                f"cohort streaming supports the 'standard' convention basis or None, got "
                f"{basis!r} (per-client basis arrays would have to stream with the cohort)")
        self._basis_kind = basis
        self._basis_cohort = self._make_basis(self._slots.stop - self._slots.start)
        self._basis_full = self._make_basis(self.n)
        self._seed64 = sampler_seed(self.root_key)
        self._aggs = dict(spec.cohort_aggregates()) if not self.full else {}
        self._totals: dict = {}
        self._server: dict = {}
        self._cur: Optional[dict] = None
        self._is_client = None
        self.metrics = {"prefetch_wait_us": 0.0, "prefetch_work_us": 0.0, "h2d_bytes": 0,
                        "d2h_bytes": 0, "epochs_prefetched": 0, "epochs_loaded": 0}
        self.uploads: Optional[list] = None
        self._prefetch_on = bool(prefetch) and not self.full
        self._pool = ThreadPoolExecutor(max_workers=1) if self._prefetch_on else None
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self._prefetch_on and self.device.type == "cuda" else None)
        self._pf = None
        self._pf_epoch = -1
        self._init_fleet()

    # ------------------------------------------------------------------
    # fleet init: slab by slab on the device → host store + server state
    # ------------------------------------------------------------------
    def _make_basis(self, n: int):
        return None if self._basis_kind is None else standard_basisb(self.d, n)

    def _init_fleet(self):
        spec, store, x0, dev = self.spec, self.store, self.x0, self.device
        n = self.n
        names = tuple(getattr(spec, "carry_names", ()))
        slabs = [(lo, min(lo + self.slab, n)) for lo in range(0, n, self.slab)]
        state: dict = {}
        extras_sums: dict = {}
        env_last = carry_last = None
        for lo, hi in slabs:
            sn = hi - lo
            batch = store.gather_batch(np.arange(lo, hi), dev)
            basisb = self._make_basis(sn)
            R = rounds.VmapReducer(n=sn, device=dev)
            # the stacked driver's init: at one slab the carry is the
            # stacked engine's, bit for bit
            carry = rounds.serve_init(spec, R, batch, basisb, x0)
            if self._is_client is None:
                self._split_carry_contract(spec, names, carry, batch, basisb, x0)
            for name, elem, cl in zip(names, carry, self._is_client):
                if cl:
                    arr = elem.cpu().numpy()
                    if name not in state:
                        state[name] = np.empty((n,) + arr.shape[1:], arr.dtype)
                    state[name][lo:hi] = arr
                elif lo == 0:
                    self._server[name] = elem
            if len(slabs) > 1:
                for ename, ev in _slab_extras(spec, R, batch, basisb, x0, carry).items():
                    s = np.sum(ev.cpu().numpy().astype(np.float64), axis=0)
                    extras_sums[ename] = s if ename not in extras_sums else extras_sums[ename] + s
                if hi == n:
                    env_last = rounds.Env(batch=batch, basisb=basisb, x0=x0,
                                          extra=spec.prepare(R, batch, basisb, x0))
                    carry_last = carry
        store.state = state
        if len(slabs) > 1:
            # server elements derived from a fleet reduction (BAG's
            # H⁰ = meanᵢ recon(L⁰ᵢ) + ridge) come from the sums over slabs
            over = spec.cohort_server_init(
                env_last, {k: torch.as_tensor(v, device=dev) for k, v in extras_sums.items()},
                n, carry_last)
            self._server.update(over)
        for agg, (leaf, op) in self._aggs.items():
            if op == "mean":
                self._totals[agg] = np.sum(state[leaf].astype(np.float64), axis=0)

    def _split_carry_contract(self, spec, names, carry, batch, basisb, x0):
        if not isinstance(carry, tuple) or len(names) != len(carry):
            raise ValueError(
                f"{type(spec).__name__}.carry_names has {len(names)} names but init returns "
                f"{len(carry) if isinstance(carry, tuple) else type(carry)} elements: the "
                "streaming engine needs one name per top-level carry element")
        flags = rounds.carry_client_flags(spec, batch, basisb, x0)
        is_client = []
        for name, fl, elem in zip(names, flags, carry):
            if any(fl) and not all(fl):
                raise ValueError(f"carry element {name!r} mixes client-stacked and server "
                                 "leaves: not streamable")
            cl = bool(fl) and all(fl)
            if cl and not isinstance(elem, torch.Tensor):
                raise ValueError(f"client-stacked carry element {name!r} must be a single "
                                 "tensor to live in the ClientStore")
            is_client.append(cl)
        self._is_client = tuple(is_client)
        for agg, (leaf, _op) in self._aggs.items():
            if leaf not in names or not is_client[names.index(leaf)]:
                raise ValueError(f"cohort aggregate {agg!r} references carry leaf {leaf!r}, "
                                 "which is not a client-stacked element")
        self._names = names

    # ------------------------------------------------------------------
    # cohort sampling
    # ------------------------------------------------------------------
    def cohort_indices(self, epoch: int) -> np.ndarray:
        """The epoch's sorted cohort (unique global indices), a function of
        (root key, epoch) only (`cohort_indices`); the fleet in full mode."""
        if self.full:
            return np.arange(self.n, dtype=np.int64)
        return cohort_indices(self._seed64, self.n, self.cohort, epoch)

    # ------------------------------------------------------------------
    # data movement: the epoch's A and b onto the device
    # ------------------------------------------------------------------
    def _padded(self, idx: np.ndarray):
        """The cohort over the engine's ``cap`` slots: global indices (0 in
        a padded slot) and the mask of slots that hold a client."""
        pidx = np.zeros(self.cap, np.int64)
        pidx[:idx.size] = idx
        real = np.zeros(self.cap, bool)
        real[:idx.size] = True
        return pidx, real

    def _gather(self, epoch: int, side_stream: bool):
        """The epoch's cohort and the data of this rank's slots on the
        device.  With ``side_stream`` (a CUDA device) the rows are gathered
        straight into pinned host memory and copied on the engine's copy
        stream; the returned event marks the copy's end."""
        idx = self.cohort_indices(epoch)
        rows = self._padded(idx)[0][self._slots]
        if not side_stream:
            A, b = self.store.gather_data(rows)
            return (idx, torch.tensor(A, device=self.device),
                    torch.tensor(b, device=self.device), None)
        st = self.store
        A_h = torch.empty((rows.size,) + st.A.shape[1:], dtype=torch.float64, pin_memory=True)
        b_h = torch.empty((rows.size,) + st.b.shape[1:], dtype=torch.float64, pin_memory=True)
        np.take(st.A, rows, axis=0, out=A_h.numpy())
        np.take(st.b, rows, axis=0, out=b_h.numpy())
        with torch.cuda.stream(self._copy_stream):
            A = A_h.to(self.device, non_blocking=True)
            b = b_h.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return idx, A, b, done

    def _count_h2d(self, *tensors):
        self.metrics["h2d_bytes"] += sum(t.numel() * t.element_size() for t in tensors)

    def _to_device(self, arr) -> torch.Tensor:
        """A copy of a host array on the engine's device, its bytes counted."""
        t = torch.tensor(arr, device=self.device)
        self._count_h2d(t)
        return t

    def _prefetch_submit(self, epoch: int):
        if not self._prefetch_on or self._pf_epoch == epoch:
            return

        def work():
            w0 = time.perf_counter()
            out = self._gather(epoch, self._copy_stream is not None)
            return out, time.perf_counter() - w0

        self._pf_epoch = epoch
        self._pf = self._pool.submit(work)

    def _fetch_epoch(self, epoch: int):
        if self._pf is not None and self._pf_epoch == epoch:
            w0 = time.perf_counter()
            (idx, A, b, done), work_s = self._pf.result()
            self._pf = None
            self.metrics["prefetch_wait_us"] += (time.perf_counter() - w0) * 1e6
            self.metrics["prefetch_work_us"] += work_s * 1e6
            self.metrics["epochs_prefetched"] += 1
            if done is not None:
                # the compute stream reads the copy only after it ends, and
                # the allocator keeps the buffers until the compute is done
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(done)
                A.record_stream(compute)
                b.record_stream(compute)
            return idx, A, b
        return self._gather(epoch, False)[:3]

    @property
    def layout(self) -> Optional[dict]:
        """How a sharded engine lays its slots over the world
        (`mesh.ClientGroup.describe`); None unsharded."""
        return self._R.group.describe() if self.sharded else None

    @property
    def prefetch_overlap(self) -> float:
        """Share of the prefetch work hidden behind compute, 1 − wait/work
        over the prefetched epochs (1.0: fully overlapped)."""
        work = self.metrics["prefetch_work_us"]
        if work <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.metrics["prefetch_wait_us"] / work)

    # ------------------------------------------------------------------
    # epoch residency
    # ------------------------------------------------------------------
    def _epoch_state(self, epoch, idx, batch, carry, frozen_np) -> dict:
        pidx, real = self._padded(idx)
        return {"epoch": epoch, "idx": idx,
                "cidx": self._to_device(pidx[self._slots].astype(np.int32)),
                "real": None if real.all() else self._to_device(real[self._slots]),
                "batch": batch, "carry": tuple(carry),
                "frozen": {k: self._to_device(v) for k, v in frozen_np.items()},
                "frozen_np": frozen_np}

    def _load_epoch(self, epoch: int):
        idx, A, b = self._fetch_epoch(epoch)
        self._count_h2d(A, b)
        self.metrics["epochs_loaded"] += 1
        batch = client_batch.ClientBatch(A=A, b=b, lam=self.store.lam)
        rows = self._padded(idx)[0][self._slots]
        elems = [self._to_device(self.store.state[name][rows]) if cl else self._server[name]
                 for name, cl in zip(self._names, self._is_client)]
        frozen_np = {}
        for agg, (leaf, op) in self._aggs.items():
            if op == "mean":
                rows = self.store.state[leaf][idx].astype(np.float64)
                frozen_np[agg] = self._totals[agg] - rows.sum(axis=0)
            else:  # max over the absent clients (streaming: some exist)
                mask = np.ones(self.n, bool)
                mask[idx] = False
                frozen_np[agg] = np.max(self.store.state[leaf][mask].astype(np.float64), axis=0)
        self._cur = self._epoch_state(int(epoch), idx, batch, elems, frozen_np)
        self._prefetch_submit(epoch + 1)

    def _cohort_rows(self, carry) -> dict:
        """The client-stacked carry elements with the cohort's rows, padded
        slots (always the last) dropped: gathered from every rank when
        sharded (one collective a dtype), so every rank's store takes every
        row."""
        elems = {name: elem for name, elem, cl in zip(self._names, carry, self._is_client)
                 if cl}
        if self.sharded:
            elems = {name: rows[:self.cohort] for name, rows in
                     self._R.fleet_tree(elems).items()}
        return elems

    def _unload_current(self):
        cur = self._cur
        if cur is None:
            return
        new_rows = {}
        cohort_rows = self._cohort_rows(cur["carry"])
        for name, elem, cl in zip(self._names, cur["carry"], self._is_client):
            if cl:
                rows = cohort_rows[name].cpu().numpy()
                self.metrics["d2h_bytes"] += rows.nbytes
                self.store.state[name][cur["idx"]] = rows
                new_rows[name] = rows
            else:
                self._server[name] = elem
        for agg, (leaf, op) in self._aggs.items():
            if op == "mean":
                # totals = frozen (absent, unchanged) + the updated cohort rows
                self._totals[agg] = (cur["frozen_np"][agg]
                                     + new_rows[leaf].astype(np.float64).sum(axis=0))
        self._cur = None

    def _full_carry(self) -> tuple:
        return tuple(self._to_device(self.store.state[name]) if cl else self._server[name]
                     for name, cl in zip(self._names, self._is_client))

    def _local_carry(self, carry) -> tuple:
        """This rank's shard of a one-rank-layout carry: its slots' rows of
        the client-stacked elements, a padded slot taking client 0's rows
        (None off the client group)."""
        if not self.sharded:
            return tuple(carry)
        if not self._R.group.active:
            return None
        pad = self.cap - (self.n if self.full else self.cohort)
        out = []
        for name, elem, cl in zip(self._names, carry, self._is_client):
            if cl and pad:
                elem = torch.cat([elem, elem[:1].expand((pad,) + tuple(elem.shape[1:]))])
            out.append(elem[self._slots].clone() if cl else elem)
        return tuple(out)

    def _full_state(self, carry) -> dict:
        batch = self.store.gather_batch(np.arange(self.n), self.device)
        self._count_h2d(batch.A, batch.b)
        return {"epoch": None, "idx": np.arange(self.n), "batch": batch,
                "carry": self._local_carry(carry), "frozen_np": {}}

    # ------------------------------------------------------------------
    # driver
    # ------------------------------------------------------------------
    def run_chunk(self, t0: int, steps: int):
        """Run rounds [t0, t0 + steps) and return the streams ``(eval_x,
        CommLedger of streams, events)``, as `rounds.run_chunk` does, and
        set ``uploads`` to these rounds' uploading clients.  Runs are cut at
        epoch boundaries inside; any cutting of calls gives the same
        streams."""
        outs = []
        self.uploads = None if self.full else []
        t = int(t0)
        end = t + int(steps)
        while t < end:
            if self.full:
                if self._cur is None:
                    self._cur = self._full_state(self._full_carry())
                cur = self._cur
                seg = end - t
                carry, ys = rounds.run_chunk(self.spec, cur["batch"], self._basis_full, self.x0,
                                             cur["carry"], t, seg, self.root_key,
                                             sharded=self.sharded, exact=self.exact)
            else:
                e = t // self.rpc
                if self._cur is None or self._cur["epoch"] != e:
                    self._unload_current()
                    self._load_epoch(e)
                cur = self._cur
                seg = min(end, (e + 1) * self.rpc) - t
                carry, ys, ups = rounds.run_cohort_chunk(
                    self.spec, cur["batch"], self._basis_cohort, self.x0, cur["carry"], t, seg,
                    self.root_key, cidx=cur["cidx"], frozen=cur["frozen"], n_global=self.n,
                    real=cur["real"], sharded=self.sharded, exact=self.exact, cap=self.cap)
                self.uploads += [cur["idx"][row[:self.cohort]] for row in ups.cpu().numpy()]
            cur["carry"] = carry
            outs.append(ys)
            t += seg
        return rounds.concat_streams(outs)

    # ------------------------------------------------------------------
    # checkpoint plumbing (repro.exp/ckpt@2)
    # ------------------------------------------------------------------
    def carry_template(self) -> tuple:
        """Shape and dtype template of the device carry, in the one-rank
        layout (a sharded engine's checkpoints are the one-rank engine's)."""
        if self.full:
            return self._full_carry()
        return tuple(
            torch.zeros((self.cohort,) + self.store.state[name].shape[1:],
                        dtype=torch.from_numpy(self.store.state[name][:0]).dtype,
                        device=self.device) if cl else self._server[name]
            for name, cl in zip(self._names, self._is_client))

    def unflatten_carry(self, leaves) -> tuple:
        """A carry from `checkpoint_payload`'s leaves, each put on the
        device (and in the dtype) of the template's leaf."""
        template = self.carry_template()
        return rounds.carry_from_leaves(template, [
            self._to_device(np.asarray(x)).to(device=t.device, dtype=t.dtype)
            for x, t in zip(leaves, rounds.carry_leaves(template))])

    def _one_rank_carry(self, carry) -> tuple:
        """A carry in the one-rank layout: sharded, the slots' rows gathered
        from every rank and the padded slots dropped."""
        if not self.sharded:
            return carry
        rows = self._cohort_rows(carry)
        return tuple(rows[name] if cl else elem
                     for name, elem, cl in zip(self._names, carry, self._is_client))

    def checkpoint_payload(self):
        """``(carry_leaves, host_state)``: numpy copies of the device
        carry's leaves (the one-rank layout; sharded, every rank of the
        client group must call, and gets the same payload) and, when
        streaming, of the host state — the store (the resident cohort's
        rows at their epoch-start values), the aggregate totals and the
        epoch's frozen statistics — all `restore` needs to resume bit for
        bit mid-epoch or at a boundary.  A rank off the client group (full
        mode) gets None leaves."""
        if self._cur is None:
            raise RuntimeError("no rounds have run: nothing to checkpoint")
        if self._cur["carry"] is None:
            return None, {}
        leaves = [leaf.detach().cpu().numpy().copy()
                  for leaf in rounds.carry_leaves(self._one_rank_carry(self._cur["carry"]))]
        if self.full:
            return leaves, {}
        host = {f"store/{k}": v.copy() for k, v in self.store.state.items()}
        host.update({f"totals/{k}": np.array(v) for k, v in self._totals.items()})
        host.update({f"frozen/{k}": np.array(v) for k, v in self._cur["frozen_np"].items()})
        return leaves, host

    def restore(self, t: int, carry, host_state: Optional[dict]):
        """Adopt a checkpoint taken at round ``t`` (``carry`` from
        `unflatten_carry`).  The resident epoch is ``(t − 1) // rpc``, the
        epoch of the last round run; its cohort is drawn again and its
        data gathered from the store."""
        if self.full:
            self._cur = self._full_state(carry)
            return
        host_state = host_state or {}
        missing = ({f"frozen/{a}" for a in self._aggs}
                   - {k for k in host_state if k.startswith("frozen/")})
        if missing:
            raise ValueError(f"checkpoint host_state lacks {sorted(missing)}: not a "
                             "cohort-streaming checkpoint for this spec")
        frozen_np = {}
        for key, val in host_state.items():
            if key.startswith("store/"):
                self.store.state[key[len("store/"):]] = np.array(val)
            elif key.startswith("totals/"):
                self._totals[key[len("totals/"):]] = np.array(val, np.float64)
            elif key.startswith("frozen/"):
                frozen_np[key[len("frozen/"):]] = np.array(val, np.float64)
        e = (int(t) - 1) // self.rpc
        idx, A, b, _ = self._gather(e, False)
        self._count_h2d(A, b)
        batch = client_batch.ClientBatch(A=A, b=b, lam=self.store.lam)
        self._cur = self._epoch_state(e, idx, batch, self._local_carry(carry), frozen_np)
        self._prefetch_submit(e + 1)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
