"""Deterministic fault injection for the federated service loop — port of
`repro.core.faults` (numpy only; the port keeps its own copy).

The batch engine models client unreliability with one Bernoulli draw per
round (`rounds.participation`).  A *service* loop has to survive richer
failure modes — clients that drop and rejoin on schedules, stragglers that
miss their round deadline, and the server process itself dying — and it has
to survive them **reproducibly**: the whole point of the chunked driver's
bit-exact-resume contract (`rounds.run_chunk`) is that a crashed-and-resumed
run replays the identical trajectory, which it can only do if the fault
stream replays too.

So every draw here is a *pure function of (fault seed, absolute round)*:
`np.random.default_rng([seed, t, salt])` seeds a fresh generator per round,
there is no generator state to checkpoint, and the availability schedule for
rounds [t0, t0+K) is the same whether it is queried in one chunk or ten.
The layer composes three mechanisms into one per-round availability mask
(`FaultPlan.round_avail`), which reaches method specs as `RoundCtx.avail`:

  * **i.i.d. dropout** — each client independently unreachable with
    probability `dropout_p` each round (the service-loop generalization of
    the participation draw: availability ∧ participation).
  * **Outage windows** — deterministic down/rejoin schedules
    (`Outage(client, start, stop)`): client is down for rounds
    start ≤ t < stop and rejoins afterwards.
  * **Stragglers** — per-round response-time draws against a round
    deadline with retry/backoff (`StragglerModel`): a client misses the
    round only if it times out on *every* attempt, so the surviving set is
    monotone in the retry budget.

The server-side failure mode is `CrashInjector`: a SIGKILL of the serving
process itself at a configured round boundary, *before* the covering
checkpoint is written — the harness for the kill-9-and-resume acceptance
test (`repro_torch.launch.fed_serve --crash-after-round`).
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional, Tuple

import numpy as np

#: rng salts so the dropout and straggler streams never collide
_SALT_DROPOUT = 1
_SALT_SLOW = 2
_SALT_DELAY = 3


def _round_rng(seed: int, t: int, salt: int) -> np.random.Generator:
    """Fresh generator for one (seed, round, stream) triple — stateless
    across rounds, so fault draws are invariant to chunk boundaries."""
    return np.random.default_rng([int(seed), int(t), int(salt)])


@dataclasses.dataclass(frozen=True)
class Outage:
    """Client ``client`` is down for rounds ``start <= t < stop`` and
    rejoins at ``stop`` (a deterministic dropout/rejoin schedule)."""

    client: int
    start: int
    stop: int

    def __post_init__(self):
        if self.stop <= self.start:
            raise ValueError(f"empty outage window [{self.start}, {self.stop})")
        if self.client < 0:
            raise ValueError(f"negative client index {self.client}")

    def down(self, t: int) -> bool:
        return self.start <= t < self.stop

    @classmethod
    def parse(cls, spec: str) -> "Outage":
        """Parse the CLI form ``client:start:stop``."""
        try:
            c, a, b = (int(p) for p in spec.split(":"))
        except ValueError:
            raise ValueError(
                f"outage spec {spec!r} is not client:start:stop") from None
        return cls(client=c, start=a, stop=b)


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Per-round client response delays against a deadline with retries.

    Each attempt ``a`` (0-based, up to ``retries`` extra tries) redraws every
    client's response time from Exponential(``mean_s``) — scaled by
    ``slow_factor`` for the deterministic ``slow_frac`` fraction of
    persistently slow clients — and accepts clients whose draw beats the
    backed-off deadline ``timeout_s * backoff**a``.  A client misses the
    round only when every attempt times out, so the surviving cohort can
    only grow with the retry budget (pinned by tests/test_torch_faults.py)."""

    mean_s: float = 0.05
    slow_frac: float = 0.0
    slow_factor: float = 10.0
    timeout_s: float = 0.25
    retries: int = 1
    backoff: float = 2.0

    def __post_init__(self):
        if self.timeout_s <= 0 or self.mean_s <= 0:
            raise ValueError("straggler timeout_s and mean_s must be > 0")
        if self.retries < 0:
            raise ValueError(f"negative retry budget {self.retries}")
        if self.backoff < 1.0:
            raise ValueError(
                f"backoff {self.backoff} < 1 shrinks the retry deadline")
        if not 0.0 <= self.slow_frac <= 1.0:
            raise ValueError(f"slow_frac {self.slow_frac} outside [0, 1]")

    def slow_mask(self, seed: int, n: int) -> np.ndarray:
        """The persistently slow clients — one draw per *run*, not per
        round (salted on the fault seed only, t pinned to 0)."""
        return _round_rng(seed, 0, _SALT_SLOW).random(n) < self.slow_frac

    def round_outcome(self, seed: int, t: int, n: int
                      ) -> Tuple[np.ndarray, float]:
        """(responded mask (n,), simulated seconds the server waited)."""
        slow = self.slow_mask(seed, n)
        scale = np.where(slow, self.mean_s * self.slow_factor, self.mean_s)
        ok = np.zeros(n, bool)
        waited = 0.0
        for a in range(self.retries + 1):
            deadline = self.timeout_s * self.backoff ** a
            delays = _round_rng(seed, t, _SALT_DELAY + a).exponential(scale)
            ok = ok | (delays <= deadline)
            # the server waits out the full deadline unless everyone is in
            waited += float(delays.max()) if ok.all() else deadline
            if ok.all():
                break
        return ok, waited


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The composed per-round fleet availability schedule.

    ``round_avail(t)`` ANDs the three mechanisms into one (n,) bool mask —
    a pure function of ``(seed, t)``, so schedules are chunk-invariant and
    nothing here needs checkpointing.  ``trivial`` plans (no mechanism
    configured) stand for a fully reliable fleet; `repro_torch.launch.fed_serve`
    passes ``avail=None`` to the engine in that case, which is
    bitwise-identical to an all-ones schedule (pinned by tests)."""

    n: int
    dropout_p: float = 0.0
    outages: Tuple[Outage, ...] = ()
    straggler: Optional[StragglerModel] = None
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.dropout_p < 1.0:
            raise ValueError(f"dropout_p {self.dropout_p} outside [0, 1)")
        for o in self.outages:
            if o.client >= self.n:
                raise ValueError(
                    f"outage client {o.client} out of range for n={self.n}")

    @property
    def trivial(self) -> bool:
        return (self.dropout_p == 0.0 and not self.outages
                and self.straggler is None)

    def round_avail(self, t: int) -> Tuple[np.ndarray, float]:
        """(availability mask (n,) bool, simulated straggler wait seconds)
        for absolute round ``t``."""
        up = np.ones(self.n, bool)
        if self.dropout_p > 0.0:
            up &= (_round_rng(self.seed, t, _SALT_DROPOUT).random(self.n)
                   >= self.dropout_p)
        for o in self.outages:
            if o.down(t):
                up[o.client] = False
        waited = 0.0
        if self.straggler is not None:
            ok, waited = self.straggler.round_outcome(self.seed, t, self.n)
            up &= ok
        return up, waited

    def schedule(self, t0: int, steps: int) -> Tuple[np.ndarray, float]:
        """Availability schedule for rounds [t0, t0+steps) — the (steps, n)
        bool array `rounds.run_chunk` consumes — plus the chunk's total
        simulated straggler wait."""
        rows, waited = [], 0.0
        for t in range(t0, t0 + steps):
            up, w = self.round_avail(t)
            rows.append(up)
            waited += w
        return np.stack(rows), waited

    def describe(self) -> dict:
        """Plain-JSON form for the serve config digest (fault plans are
        part of the run identity: changing one invalidates checkpoints)."""
        return {
            "n": self.n,
            "dropout_p": self.dropout_p,
            "outages": [dataclasses.asdict(o) for o in self.outages],
            "straggler": (None if self.straggler is None
                          else dataclasses.asdict(self.straggler)),
            "seed": self.seed,
        }


@dataclasses.dataclass(frozen=True)
class CrashInjector:
    """SIGKILL the serving process once round ``after_round`` has been
    *computed* but before its covering checkpoint is written — exactly the
    mid-chunk hard-crash the resume contract must survive.  The restarted
    process must NOT re-arm the injector (the CLI flag is simply omitted on
    restart), or it will crash at the same boundary forever."""

    after_round: int

    def maybe_crash(self, t_done: int) -> None:
        if t_done > self.after_round:
            # flush stdio so the pre-crash log survives the SIGKILL
            import sys

            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
