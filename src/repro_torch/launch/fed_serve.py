"""Fault-tolerant federated service loop over the round engine — port of
`repro.launch.fed_serve`.

    python -m repro_torch.launch.fed_serve --exp fig4 --cell BL2_tau_half \
        --max-rounds 200 --chunk 25 --ckpt-dir runs/serve [--device cpu]

Where `repro_torch.exp` runs a cell as one fixed-length run and exits, this
launcher *serves* it: rounds run in bounded-length chunks through the
chunked driver (`repro_torch.core.rounds.run_chunk`; control returns to the
host every chunk), and between chunks the orchestrator

  1. **injects faults** — a `repro_torch.core.faults.FaultPlan` (i.i.d.
     dropout, deterministic outage windows, straggler timeouts with
     retry/backoff) materializes the next chunk's availability schedule,
     which reaches the method spec as `RoundCtx.avail`.  When a round's
     surviving cohort falls below its τ target the engine degrades
     gracefully (force-one-client fallback) and the round is flagged in the
     events stream (`History.events`, `rounds.EVENT_*` bitmasks).
  2. **checkpoints** the full server state — carry (iterate, shifts,
     `comm.CommLedger`), accumulated history streams, root PRNG key and
     round counter — via `repro_torch.exp.artifacts.save_checkpoint`
     (``repro.exp/ckpt@2``, atomically written, digest-keyed to this serve
     config, in the reference's layout).  A carry whose Hessian
     coefficients are held in a computed basis (the data basis's SVD, the
     eigenbasis) also records which basis that was (`basis_fingerprint`,
     in ``host_state``): an SVD's column signs differ between LAPACK
     builds and between the CPU and the card, so a resume maps the
     coefficients into its own basis (`_rebase_coefficients`), and refuses
     a checkpoint that does not name its basis — the JAX package's among
     them.  Carries in a convention basis (standard, symmetric, PSD, DCT)
     resume across packages and devices as they are.

The loop serves without a program cache (the reference's AOT cache,
``--progcache-dir``, is ROADMAP.md §1 item 16): ``--no-progcache`` is
accepted and ``meta.progcache`` is null.  Time-to-first-round lands in the
record's ``meta`` (``ttfr_s``).  ``--metrics-out`` additionally streams an
append-only, crash-safe JSONL line per round (round, gap, degradation
events, per-leg ledger bits — `MetricsSink`).

Because per-round PRNG keys are ``fold_in(root_key, t)`` and every fault
draw is a pure function of ``(fault seed, t)``, the trajectory does not
depend on chunk boundaries: kill -9 the process at any point, rerun the
same command, and the run resumes from the latest valid checkpoint bit for
bit — trajectory, `History.events` and per-leg `CommLedger` bit streams all
equal an uninterrupted run at the same seed (tests/test_torch_serve.py,
`chip_smoke.py`'s phase ``serve``).  ``--crash-after-round N`` arms
`faults.CrashInjector`: a deterministic in-process SIGKILL after round N is
computed but before its covering checkpoint lands (omit the flag on
restart, or it crashes at the same boundary forever).

Supported methods: the GLM specs with client-stacked state (bl1, bl2, bl3,
fednl_bag), and the store-backed ``synthetic_stream`` cells on the cohort
engine.  Fault injection additionally requires the method to react to
availability (`MethodSpec.supports_faults`: bl2/bl3 partial participation,
fednl_bag lazy aggregation) — serving bl1 works, but injecting faults into
it is refused rather than silently ignored.  Runs on the card unless
``device="cpu"`` / ``--device cpu``.

``fast+sharded`` and ``cohort+sharded`` shard the fleet (or each cohort)
over the ranks of a `torch.distributed` world (``torchrun --nproc-per-node
W -m repro_torch.launch.fed_serve …``; one process is a one-rank world):
each rank runs its clients' rows of the carry, rank 0 writes the ckpt@2
checkpoints from carries gathered to the one-rank layout (and the result
record), and a checkpoint taken at one world size resumes at another bit
for bit.  A rank killed mid-run ends the others with an error from the
next collective (they time out after ``REPRO_DIST_TIMEOUT_S`` at the
latest), never a hang or a zero exit.  The record's ``meta.layout`` states
the world, the ranks holding clients and the process-group backend.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..core import batched, cohort, comm, faults, prng, rounds
from ..exp import artifacts
from ..exp.engine import StreamProblem, _comp, build_problem, build_stream_spec, resolve_backend
from ..exp.registry import get_experiment
from . import mesh

#: methods the serve loop can drive (GLM specs; the DNN spec's pytree
#: eval stream needs a different stream accumulator)
SERVE_METHODS = ("bl1", "bl2", "bl3", "fednl_bag")

#: checkpoint stream names: eval iterates, events, one per ledger leg
_STREAMS = ("eval_x", "events") + tuple(f"led_{leg}" for leg in comm.CommLedger.LEGS)


def build_setup(exp, cell, prob):
    """(spec, batch, basisb) for a registered cell — the static half of a
    run, shared between the batch engine and the serve loop (the
    `repro_torch.core.batched` ``*_setup`` factorization)."""
    m = cell.method
    if m not in SERVE_METHODS:
        raise SystemExit(
            f"fed_serve drives methods {', '.join(SERVE_METHODS)}; cell "
            f"{cell.name!r} uses {m!r} (run it via `python -m repro_torch.exp`)")
    params = cell.params_dict()
    params.pop("seed", None)        # the serve PRNG root comes from --seed
    n, d = prob.n, prob.d
    clients = prob.clients
    hc = [_comp(cell.hess_comp, d, "hessian")] * n
    if m == "bl1":
        mc = _comp(cell.model_comp, d, "model")
        return batched.bl1_setup(clients, prob.bases(cell.basis), hc, mc, **params)
    if m == "bl2":
        mc = [_comp(cell.model_comp, d, "model")] * n
        return batched.bl2_setup(clients, prob.bases(cell.basis), hc, mc, **params)
    if m == "bl3":
        mc = [_comp(cell.model_comp, d, "model")] * n
        return batched.bl3_setup(clients, hc, mc, **params)
    return batched.fednl_bag_setup(clients, prob.bases(cell.basis), hc, **params)


def serve_config(exp, cell, seed: int, backend: str, plan: faults.FaultPlan) -> dict:
    """The serve run's identity record — digest-keyed checkpoints resume
    only runs with identical identity.  Deliberately excludes the chunk
    length and round budget: chunking does not change the trajectory (the
    fold_in key contract), and raising ``--max-rounds`` on a finished run
    *extends* it from its last checkpoint instead of restarting."""
    return {
        "schema": artifacts.SERVE_SCHEMA,
        "experiment": exp.name,
        "problem": dataclasses.asdict(exp.problem),
        "cell": dataclasses.asdict(cell),
        "seed": seed,
        "backend": backend,
        "faults": plan.describe(),
    }


def _resolve_backend(cell, override: Optional[str]) -> str:
    """The serve config's backend string: ``fast``, or ``fast+sharded``
    over the ranks of this process's world."""
    backend = override or cell.backend
    if backend == "auto":
        backend = "fast"
    if backend not in ("fast", "fast+sharded"):
        raise SystemExit(
            f"fed_serve runs on the engine backends 'fast' or "
            f"'fast+sharded', not {backend!r} (the reference backend has "
            "no checkpointable scan carry)")
    return resolve_backend(backend)


def _resolve_cohort_backend(cell, override: Optional[str]) -> str:
    backend = override or cell.backend
    if backend == "auto":
        backend = "cohort"
    if backend not in ("cohort", "cohort+sharded"):
        raise SystemExit(
            f"a synthetic_stream cell serves on the 'cohort' or "
            f"'cohort+sharded' backends, not {backend!r} (the stacked "
            "backends would materialize the whole fleet on device)")
    return resolve_backend(backend)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _key_data(root_key: torch.Tensor) -> np.ndarray:
    """A PRNG key as the reference stores it: jax's uint32 (2,) key data."""
    return _host(root_key).astype(np.uint32)


def _empty_streams(d: int) -> dict:
    z64 = lambda: np.zeros((0,), np.float64)
    return {"eval_x": np.zeros((0, d), np.float64),
            "events": np.zeros((0,), np.int32),
            **{f"led_{leg}": z64() for leg in comm.CommLedger.LEGS}}


def _append_chunk(streams: dict, ys) -> dict:
    xs, leds, evs = ys
    cat = lambda name, arr: np.concatenate([streams[name], _host(arr)], axis=0)
    out = {"eval_x": cat("eval_x", xs), "events": cat("events", evs)}
    for leg in comm.CommLedger.LEGS:
        out[f"led_{leg}"] = cat(f"led_{leg}", getattr(leds, leg))
    return out


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _restore_carry(ck: dict, template):
    """Checkpoint leaves → carry, validated leaf by leaf against a fresh
    `init_serve_carry` (or `CohortEngine.carry_template`): a spec whose
    carry changed shape fails loudly, not bit-rottingly.  Each leaf lands
    on its template leaf's device."""
    leaves0 = rounds.carry_leaves(template)
    got = ck["carry_leaves"]
    if len(got) != len(leaves0):
        raise SystemExit(
            f"checkpoint carry has {len(got)} leaves, this spec expects "
            f"{len(leaves0)} — the method's carry structure changed; "
            "delete the checkpoint directory to restart from round 0")
    for i, (g, w) in enumerate(zip(got, leaves0)):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != _numpy_dtype(w):
            raise SystemExit(
                f"checkpoint carry leaf {i} is {g.dtype}{tuple(g.shape)}, "
                f"spec expects {_numpy_dtype(w)}{tuple(w.shape)}"
                " — incompatible checkpoint; delete the checkpoint "
                "directory to restart from round 0")
    return rounds.carry_from_leaves(
        template, [torch.tensor(np.asarray(g), device=w.device) for g, w in zip(got, leaves0)])


#: the carry element holding each method's per-client Hessian coefficients
#: in its basis (BL3's coefficients are in the PSD convention basis)
_COEFF_ELEM = {"bl1": 2, "bl2": 2, "fednl_bag": 1}

#: ``host_state`` names of a stacked serve's basis fingerprint
_PIVOT_ROW, _PIVOT_VAL = "basis/pivot_row", "basis/pivot_val"


def _basis_factor(basisb) -> Optional[np.ndarray]:
    """The computed factor a carry's coefficients are held in, (n, d, r)
    float64 on the host: the data basis's V, a rotation's Q; None for a
    convention basis."""
    for f in ("V", "Q"):
        F = getattr(basisb, f, None)
        if F is not None:
            return _host(F).astype(np.float64)
    return None


def _pivots(F: np.ndarray, row: np.ndarray) -> np.ndarray:
    return np.take_along_axis(F, row[:, None, :], axis=1)[:, 0, :]


def basis_fingerprint(basisb) -> dict:
    """The ``host_state`` that names the basis a stacked carry is held in:
    for each client and column of the factor, the row of its largest
    |entry| (ties to the earliest) and that entry.  A column differs
    between two SVDs of the same data by its sign, and its pivot entry is
    too large (≥ 1/√d) for rounding to flip that sign.  Empty for a
    convention basis."""
    F = _basis_factor(basisb)
    if F is None:
        return {}
    row = np.abs(F).argmax(axis=1)
    return {_PIVOT_ROW: row.astype(np.int64), _PIVOT_VAL: _pivots(F, row)}


def _rebase_coefficients(ck: dict, carry, basisb, method: str):
    """``carry`` with its Hessian coefficients mapped from the basis the
    checkpoint was written in into this run's: column j of the writer's
    factor is sⱼ times this run's, so L ↦ diag(s)·L·diag(s), exactly.
    Refuses a checkpoint that does not name its basis, or whose basis
    differs from this run's by more than column signs."""
    F = _basis_factor(basisb)
    if F is None:
        return carry
    hs = ck.get("host_state") or {}
    if _PIVOT_ROW not in hs or _PIVOT_VAL not in hs:
        raise SystemExit(
            "the checkpoint holds Hessian coefficients in a computed basis but "
            "does not say which (a JAX-package checkpoint, or one written "
            "before basis fingerprints): that basis's column signs may differ "
            "from this run's — delete the checkpoint directory to restart "
            "from round 0")
    row, val = np.asarray(hs[_PIVOT_ROW]), np.asarray(hs[_PIVOT_VAL])
    if row.shape != (F.shape[0], F.shape[2]) or val.shape != row.shape:
        raise SystemExit(
            f"checkpoint basis fingerprint is {row.shape}, this run's basis "
            f"has {(F.shape[0], F.shape[2])} columns — incompatible checkpoint")
    cur = _pivots(F, row)
    if not np.allclose(np.abs(cur), np.abs(val), rtol=1e-6, atol=1e-9):
        raise SystemExit(
            "the checkpoint's basis differs from this run's by more than "
            "column signs (max |pivot| difference "
            f"{np.max(np.abs(np.abs(cur) - np.abs(val))):.3e}) — delete the "
            "checkpoint directory to restart from round 0")
    flip = (cur * val) < 0
    if not flip.any():
        return carry
    k = _COEFF_ELEM[method]
    L = carry[k]
    s = torch.ones(L.shape[:2], dtype=L.dtype, device=L.device)
    s[:, :F.shape[2]] = torch.as_tensor(np.where(flip, -1.0, 1.0), dtype=L.dtype)
    return (*carry[:k], s[:, :, None] * L * s[:, None, :], *carry[k + 1:])


class MetricsSink:
    """Append-only, crash-safe JSONL metrics stream for a serve run.

    One line per round: ``{"round", "gap", "events", "legs": {leg: bits}}``
    (cumulative per-leg `comm.CommLedger` bits, like the history record).
    Crash safety mirrors the checkpoint walk: on open, the existing file is
    scanned up to its last PARSEABLE line and emission resumes strictly
    after that round — a torn tail from a killed process is cut off (the
    reference leaves it in place, where a later reopen would stop its scan
    and emit the rounds after it twice), and re-served chunks after a
    resume never duplicate rounds.  Each chunk's lines are flushed and
    fsynced together, so the stream trails the trajectory by at most one
    chunk."""

    def __init__(self, path: str):
        self.path = path
        self.last_round = -1
        self._needs_newline = False
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            keep = 0
            for line in raw.splitlines(keepends=True):
                try:
                    rec = json.loads(line)
                    self.last_round = max(self.last_round, int(rec["round"]))
                except (ValueError, KeyError, TypeError):
                    break               # torn tail — cut it and beyond
                keep += len(line)
            if keep < len(raw):
                with open(path, "r+b") as f:
                    f.truncate(keep)
            self._needs_newline = keep > 0 and not raw[:keep].endswith(b"\n")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def emit_chunk(self, ts, gaps, events, legs: dict) -> None:
        """Append rounds ``ts`` (parallel arrays); rounds at or below the
        resume point are skipped."""
        lines = []
        for i, t in enumerate(ts):
            t = int(t)
            if t <= self.last_round:
                continue
            lines.append(json.dumps({
                "round": t,
                "gap": float(gaps[i]),
                "events": int(events[i]),
                "legs": {leg: float(legs[leg][i]) for leg in legs},
            }))
            self.last_round = t
        if not lines:
            return
        with open(self.path, "a") as f:
            if self._needs_newline:
                f.write("\n")
                self._needs_newline = False
            f.write("\n".join(lines) + "\n")
            f.flush()
            os.fsync(f.fileno())


def _no_progcache(progcache_dir: Optional[str], log) -> None:
    """The port serves without the reference's AOT program cache
    (ROADMAP.md §1 item 16): a cache directory is refused, never ignored."""
    if progcache_dir is not None:
        raise NotImplementedError(
            "--progcache-dir: the program cache is not ported yet; ROADMAP.md §1 "
            "item 16 (compile cache) brings it — drop the flag")
    log("[serve] serving without a program cache (ROADMAP.md §1 item 16)")


def _record(exp, cell, seed, digest, config, t, hist, streams, meta) -> dict:
    return {
        "schema": artifacts.SERVE_SCHEMA,
        "experiment": exp.name,
        "cell": cell.name,
        "seed": seed,
        "config_digest": digest,
        "config": config,
        "rounds": t,
        "history": {
            "gaps": [float(g) for g in hist.gaps],
            "up_bits": [float(b) for b in hist.up_bits],
            "down_bits": [float(b) for b in hist.down_bits],
            "legs": {leg: [float(v) for v in hist.legs[leg]] for leg in comm.CommLedger.LEGS},
            "events": hist.events,
        },
        "degraded_rounds": int(np.count_nonzero(streams["events"])),
        # operational facts, outside the bit-exactness contract (records are
        # compared with "meta" stripped)
        "meta": meta,
    }


def _led_streams(streams: dict) -> comm.CommLedger:
    return comm.CommLedger(*(torch.as_tensor(streams[f"led_{leg}"])
                             for leg in comm.CommLedger.LEGS))


def _serve_cohort(exp, cell, prob: StreamProblem, *, seed: int, chunk: int,
                  max_rounds: int, ckpt_dir: str, backend: Optional[str],
                  keep: int, plan: Optional[faults.FaultPlan],
                  crash_after_round: Optional[int], result_path: Optional[str],
                  metrics_out: Optional[str] = None, log=print) -> dict:
    """The serve loop over the cohort-streaming engine: same chunked
    checkpoint/resume/crash contract as the stacked path, with the engine's
    host plane (client store, fleet totals, frozen epoch stats) riding in
    the ckpt@2 ``host_state`` payload.  The trajectory does not depend on
    chunk boundaries — per-round keys are ``fold_in(root_key, t)`` and the
    cohort schedule is a function of the absolute epoch index — so kill -9
    and a rerun are bit-exact here too."""
    plan = plan if plan is not None else faults.FaultPlan(n=prob.n)
    if not plan.trivial:
        raise SystemExit(
            "cohort streaming does not take an injected fault schedule: "
            "client absence is the engine's own per-round participation "
            "draw over the global fleet (Alg. 2-3 partial participation); "
            "drop the fault flags or serve a stacked cell")
    backend = _resolve_cohort_backend(cell, backend)
    crash = (faults.CrashInjector(crash_after_round)
             if crash_after_round is not None else None)
    params = cell.params_dict()
    params.pop("seed", None)        # the serve PRNG root comes from --seed
    spec, basis, csize, rpc, _ = build_stream_spec(cell, prob.d, prob.n, prob.store.lam, params)
    config = serve_config(exp, cell, seed, backend, plan)
    digest = artifacts.config_digest(config)
    root_key = prng.PRNGKey(seed)
    t0_wall = time.perf_counter()      # time-to-first-round starts here
    eng = cohort.CohortEngine(spec, prob.store, prob.x0, cohort=csize, rounds_per_cohort=rpc,
                              root_key=root_key, basis=basis,
                              sharded=backend == "cohort+sharded")
    writer = mesh.world()[0] == 0
    log = mesh.rank0(log)
    w0 = time.perf_counter()
    ck = artifacts.load_checkpoint(ckpt_dir, config_digest=digest)
    resumed_from = restore_s = None
    if ck is not None:
        t = int(ck["t"])
        eng.restore(t, _restore_carry(ck, eng.carry_template()), ck.get("host_state"))
        streams = {name: np.asarray(ck["streams"][name]) for name in _STREAMS}
        resumed_from, restore_s = t, time.perf_counter() - w0
        log(f"[serve] {exp.name}/{cell.name}: resumed from checkpoint at "
            f"round {t} (config {digest})")
    else:
        t = 0
        streams = _empty_streams(prob.d)
        log(f"[serve] {exp.name}/{cell.name}: fresh run (config {digest}, "
            f"cohort {eng.cohort}/{eng.n})")

    sink = MetricsSink(metrics_out) if metrics_out and writer else None
    f_star = cohort.store_loss(prob.store, prob.x_star) if sink else None
    chunks_run = 0
    ttfr_s = None
    ckpt_s, chunk_s, uploads = [], [], []
    try:
        while t < max_rounds:
            steps = min(chunk, max_rounds - t)
            w0 = time.perf_counter()
            streams = _append_chunk(streams, eng.run_chunk(t, steps))
            chunk_s.append(time.perf_counter() - w0)
            if eng.uploads is not None:
                uploads += [u.tolist() for u in eng.uploads]
            t += steps
            chunks_run += 1
            if ttfr_s is None:
                ttfr_s = time.perf_counter() - t0_wall
            log(f"[serve] rounds {t - steps}..{t - 1} done (epoch {(t - 1) // rpc})")
            if sink is not None:
                xs_new = streams["eval_x"][-steps:]
                sink.emit_chunk(
                    range(t - steps, t),
                    [cohort.store_loss(prob.store, x) - f_star for x in xs_new],
                    streams["events"][-steps:],
                    {leg: streams[f"led_{leg}"][-steps:] for leg in comm.CommLedger.LEGS})
            if crash is not None:
                crash.maybe_crash(t - 1)
            w0 = time.perf_counter()
            leaves, host_state = eng.checkpoint_payload()
            if writer:
                artifacts.save_checkpoint(
                    ckpt_dir, t=t, carry_leaves=leaves, streams=streams,
                    root_key=_key_data(root_key), config_digest=digest, keep=keep,
                    host_state=host_state)
            ckpt_s.append(time.perf_counter() - w0)
    finally:
        eng.close()

    # fleet gaps evaluate slab-wise on the host (the device never holds
    # more than the cohort)
    xs = streams["eval_x"]
    f_star = cohort.store_loss(prob.store, prob.x_star) if f_star is None else f_star
    gaps = torch.tensor([cohort.store_loss(prob.store, xs[i]) - f_star
                         for i in range(xs.shape[0])], dtype=torch.float64)
    hist = batched._history({"gap": gaps}, _led_streams(streams))
    hist.events = [int(e) for e in streams["events"]]
    record = _record(exp, cell, seed, digest, config, t, hist, streams, {
        "backend": backend,
        "chunk": chunk,
        "chunks_run": chunks_run,
        "resumed_from": resumed_from,
        "straggler_wait_s": 0.0,
        "runtime_s": time.perf_counter() - t0_wall,
        "ttfr_s": ttfr_s,
        "chunk_s": chunk_s,
        "checkpoint_s": ckpt_s,
        "restore_s": restore_s,
        "progcache": None,
        "cohort": eng.cohort,
        "rounds_per_cohort": rpc,
        "n_clients": eng.n,
        "prefetch_overlap": eng.prefetch_overlap,
        "prefetch": dict(eng.metrics),
        # each round this call ran: the global indices of the clients that
        # uploaded (`CohortEngine.uploads`; None in full mode)
        "uploads": uploads if not eng.full else None,
        "layout": eng.layout,
    })
    if result_path and writer:
        artifacts.write_json(result_path, record)
        log(f"[serve] result → {result_path}")
    log(f"[serve] {t} rounds, final gap {record['history']['gaps'][-1]:.3e}, "
        f"prefetch overlap {eng.prefetch_overlap:.0%}")
    return record


def serve(*, exp_name: str, cell_name: str, seed: int = 0, chunk: int = 25,
          max_rounds: int = 200, ckpt_dir: str, backend: Optional[str] = None,
          keep: int = 3, plan: Optional[faults.FaultPlan] = None,
          crash_after_round: Optional[int] = None,
          result_path: Optional[str] = None,
          progcache_dir: Optional[str] = None,
          metrics_out: Optional[str] = None, log=print, device=None) -> dict:
    """Run (or resume) a serve loop to ``max_rounds``; returns the final
    serve record (also written to ``result_path`` when given).

    ``device`` (``None``: the card) is where the rounds run.
    ``progcache_dir`` raises (no program cache until ROADMAP.md §1 item
    16); ``metrics_out``
    appends a crash-safe JSONL metrics line per round (`MetricsSink`).
    ``meta.chunk_s`` holds each chunk's seconds (its rounds, with the
    streams copied to the host), ``meta.checkpoint_s`` each checkpoint's
    write seconds, ``meta.restore_s`` the seconds a resume took to load and
    adopt its checkpoint."""
    if chunk < 1:
        raise SystemExit(f"--chunk must be >= 1, got {chunk}")
    _no_progcache(progcache_dir, log)
    exp = get_experiment(exp_name)
    cell = exp.cell(cell_name)
    prob = build_problem(exp.problem, device=device)
    if isinstance(prob, StreamProblem):
        return _serve_cohort(
            exp, cell, prob, seed=seed, chunk=chunk, max_rounds=max_rounds,
            ckpt_dir=ckpt_dir, backend=backend, keep=keep, plan=plan,
            crash_after_round=crash_after_round, result_path=result_path,
            metrics_out=metrics_out, log=log)
    spec, batch, basisb = build_setup(exp, cell, prob)
    plan = plan if plan is not None else faults.FaultPlan(n=batch.n)
    if plan.n != batch.n:
        raise SystemExit(f"fault plan is for n={plan.n} clients, fleet has {batch.n}")
    if not plan.trivial and not getattr(spec, "supports_faults", False):
        raise SystemExit(
            f"method {cell.method!r} models a fully synchronous fleet and "
            "cannot absorb injected faults (MethodSpec.supports_faults is "
            "False) — drop the fault flags or serve a partial-participation "
            "cell (bl2/bl3) or fednl_bag")
    backend = _resolve_backend(cell, backend)
    crash = (faults.CrashInjector(crash_after_round)
             if crash_after_round is not None else None)
    x0, x_star = prob.x0, prob.x_star
    sharded = backend == "fast+sharded"
    R = rounds.make_reducer(spec, batch.n, x0.device, sharded=sharded)
    # the ranks off the client group hold no carry: they serve the streams
    # rank 0 shares, and rank 0 alone logs and writes
    active = not sharded or R.group.active
    writer = mesh.world()[0] == 0
    log = mesh.rank0(log)
    flags = rounds.carry_client_flags(spec, batch, basisb, x0) if sharded else None

    config = serve_config(exp, cell, seed, backend, plan)
    digest = artifacts.config_digest(config)
    t0_wall = time.perf_counter()      # time-to-first-round starts here
    template = rounds.init_serve_carry(spec, batch, basisb, x0, sharded=sharded)
    w0 = time.perf_counter()
    ck = artifacts.load_checkpoint(ckpt_dir, config_digest=digest)
    resumed_from = restore_s = None
    if ck is not None:
        t = int(ck["t"])
        carry = None
        if active:
            # the checkpoint holds the one-rank carry: rebased in the fleet's
            # basis, then cut to this rank's rows
            fleet = _rebase_coefficients(
                ck, _restore_carry(ck, rounds.fleet_template(template, R, flags)),
                basisb, cell.method)
            carry = rounds.shard_carry(fleet, R, flags)
        streams = {name: np.asarray(ck["streams"][name]) for name in _STREAMS}
        root_key = torch.as_tensor(np.asarray(ck["root_key"]).astype(np.int64))
        resumed_from, restore_s = t, time.perf_counter() - w0
        log(f"[serve] {exp.name}/{cell.name}: resumed from checkpoint at "
            f"round {t} (config {digest})")
    else:
        t = 0
        carry = template
        streams = _empty_streams(prob.d)
        root_key = prng.PRNGKey(seed)
        log(f"[serve] {exp.name}/{cell.name}: fresh run (config {digest})")

    sink = MetricsSink(metrics_out) if metrics_out and writer else None
    f_star = batched._f_star(batch, x_star)
    chunks_run = 0
    waited_total = 0.0
    ttfr_s = None
    ckpt_s, chunk_s = [], []
    fingerprint = basis_fingerprint(basisb)
    while t < max_rounds:
        steps = min(chunk, max_rounds - t)
        w0 = time.perf_counter()
        if plan.trivial:
            avail, waited = None, 0.0
        else:
            avail, waited = plan.schedule(t, steps)
        carry, ys = rounds.run_chunk(spec, batch, basisb, x0, carry, t, steps, root_key,
                                     avail=avail, sharded=sharded)
        streams = _append_chunk(streams, ys)
        chunk_s.append(time.perf_counter() - w0)
        t += steps
        chunks_run += 1
        waited_total += waited
        if ttfr_s is None:
            ttfr_s = time.perf_counter() - t0_wall
        if sink is not None:
            gaps = spec.eval_streams(
                batch, torch.as_tensor(streams["eval_x"][-steps:], device=x0.device),
                f_star)["gap"]
            sink.emit_chunk(
                range(t - steps, t), _host(gaps), streams["events"][-steps:],
                {leg: streams[f"led_{leg}"][-steps:] for leg in comm.CommLedger.LEGS})
        evs = streams["events"][-steps:]
        n_deg = int(np.count_nonzero(evs))
        log(f"[serve] rounds {t - steps}..{t - 1} done"
            + (f", {n_deg} degraded" if n_deg else "")
            + (f", straggler wait {waited:.2f}s" if waited else ""))
        if crash is not None:
            # fires BEFORE the covering checkpoint: the chunk is lost and
            # the resume path must recompute it (the acceptance scenario)
            crash.maybe_crash(t - 1)
        w0 = time.perf_counter()
        if active:
            # the carry gathered to the one-rank layout (a collective over
            # the client group); rank 0 writes it
            leaves = [_host(leaf) for leaf in rounds.carry_leaves(carry, R, flags)]
            if writer:
                artifacts.save_checkpoint(
                    ckpt_dir, t=t, carry_leaves=leaves, streams=streams,
                    root_key=_key_data(root_key), config_digest=digest, keep=keep,
                    host_state=fingerprint)
        ckpt_s.append(time.perf_counter() - w0)

    evals = spec.eval_streams(batch, torch.as_tensor(streams["eval_x"], device=x0.device), f_star)
    hist = batched._history(evals, _led_streams(streams))
    hist.events = [int(e) for e in streams["events"]]
    record = _record(exp, cell, seed, digest, config, t, hist, streams, {
        "backend": backend,
        "chunk": chunk,
        "chunks_run": chunks_run,
        "resumed_from": resumed_from,
        "straggler_wait_s": waited_total,
        "runtime_s": time.perf_counter() - t0_wall,
        "ttfr_s": ttfr_s,
        "chunk_s": chunk_s,
        "checkpoint_s": ckpt_s,
        "restore_s": restore_s,
        "progcache": None,
        "layout": R.group.describe() if sharded else None,
    })
    if result_path and writer:
        artifacts.write_json(result_path, record)
        log(f"[serve] result → {result_path}")
    log(f"[serve] {t} rounds, final gap {record['history']['gaps'][-1]:.3e}, "
        f"{record['degraded_rounds']} degraded round(s)")
    return record


def _build_plan(args, n: int) -> faults.FaultPlan:
    straggler = None
    if args.straggler_mean > 0.0:
        straggler = faults.StragglerModel(
            mean_s=args.straggler_mean, slow_frac=args.slow_frac,
            slow_factor=args.slow_factor, timeout_s=args.timeout,
            retries=args.retries, backoff=args.backoff)
    return faults.FaultPlan(
        n=n, dropout_p=args.dropout_p,
        outages=tuple(faults.Outage.parse(o) for o in args.outage),
        straggler=straggler, seed=args.fault_seed)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fed_serve",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True,
                    help="registered experiment (e.g. fig4)")
    ap.add_argument("--cell", required=True,
                    help="cell within the experiment (e.g. BL2_tau_half)")
    ap.add_argument("--seed", type=int, default=0,
                    help="root PRNG seed (per-round keys fold in the round)")
    ap.add_argument("--chunk", type=int, default=25,
                    help="rounds per chunk / checkpoint interval")
    ap.add_argument("--max-rounds", type=int, default=200,
                    help="serve until this many total rounds")
    ap.add_argument("--ckpt-dir", default="runs/serve",
                    help="checkpoint directory (resume looks here)")
    ap.add_argument("--backend",
                    choices=("fast", "fast+sharded", "cohort", "cohort+sharded"),
                    default=None, help="override the cell's engine backend "
                    "(cohort* for synthetic_stream cells)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoints retained after pruning")
    ap.add_argument("--result", default=None,
                    help="write the final serve record JSON here")
    ap.add_argument("--progcache-dir", default=None,
                    help="AOT program cache directory (not ported: ROADMAP.md §1 "
                         "item 16; raises)")
    ap.add_argument("--no-progcache", action="store_true",
                    help="serve without a program cache (the port always does)")
    ap.add_argument("--metrics-out", default=None,
                    help="append per-round JSONL metrics (round, gap, "
                         "events, per-leg ledger bits) to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device the rounds run on: cuda (default) or cpu")
    # fault injection
    ap.add_argument("--dropout-p", type=float, default=0.0,
                    help="i.i.d. per-(client, round) dropout probability")
    ap.add_argument("--outage", action="append", default=[],
                    metavar="CLIENT:START:STOP",
                    help="deterministic outage window (repeatable)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault stream seed (independent of --seed)")
    ap.add_argument("--straggler-mean", type=float, default=0.0,
                    help="mean client response delay in s (0 = no "
                         "straggler model)")
    ap.add_argument("--timeout", type=float, default=0.25,
                    help="per-round response deadline in s")
    ap.add_argument("--retries", type=int, default=1,
                    help="extra attempts for timed-out clients")
    ap.add_argument("--backoff", type=float, default=2.0,
                    help="deadline multiplier per retry")
    ap.add_argument("--slow-frac", type=float, default=0.0,
                    help="fraction of persistently slow clients")
    ap.add_argument("--slow-factor", type=float, default=10.0,
                    help="delay multiplier for slow clients")
    # crash harness
    ap.add_argument("--crash-after-round", type=int, default=None,
                    help="SIGKILL self after this round is computed but "
                         "before its checkpoint (crash test harness; omit "
                         "on restart)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    # under torchrun: the world first (the backend rule reads the device)
    mesh.init_from_env(args.device)
    exp = get_experiment(args.exp)
    prob = build_problem(exp.problem, device=_device.resolve(args.device))
    serve(exp_name=args.exp, cell_name=args.cell, seed=args.seed,
          chunk=args.chunk, max_rounds=args.max_rounds,
          ckpt_dir=args.ckpt_dir, backend=args.backend, keep=args.keep,
          plan=_build_plan(args, prob.n),
          crash_after_round=args.crash_after_round,
          result_path=args.result, progcache_dir=args.progcache_dir,
          metrics_out=args.metrics_out,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
