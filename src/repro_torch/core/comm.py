"""Communication layer: wire formats, message counts, and the per-leg ledger.

Port of `repro.core.comm`.  Compressors never compute bits: they return
message `Counts` and declare a `WireFormat`; ``price(wire, counts)`` turns
counts into bits, and the `CommLedger` accumulates bits per leg:

  * ``hess_up``    — compressed Hessian-coefficient uplink;
  * ``grad_up``    — gradient-leg uplink;
  * ``model_down`` — compressed model broadcast server → clients;
  * ``basis_ship`` — the one-time basis shipment.

Bits are float64 and integer-valued, so every sum is exact and the bit
streams equal the reference's exactly.  `BasisShipSpec` prices a shipped
basis (the BL-DNN pytree bases) through the same algebra.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import NamedTuple, Union

import torch

FLOAT_BITS = 64  # the paper's experiments (NumPy) use float64 coefficients
INDEX_BITS = 32


class Counts(NamedTuple):
    """What one compressed message physically carries, per client: leaves
    are per-client (n,) float64 tensors, or python floats for unused legs."""

    floats: Union[torch.Tensor, float] = 0.0
    indices: Union[torch.Tensor, float] = 0.0
    entries: Union[torch.Tensor, float] = 0.0


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Declarative per-unit pricing of a message's counts."""

    float_bits: int = FLOAT_BITS
    index_bits: int = INDEX_BITS
    #: bits per packed entry (e.g. 1 sign + ⌈log₂(s+1)⌉ dither levels)
    entry_bits: float = 0.0


#: a wire format, or a tuple of wire trees for composed compressors
WireTree = Union[WireFormat, tuple]


def _f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def price(wire: WireTree, counts) -> torch.Tensor:
    """Bits on the wire for `counts` under `wire`, recursing through
    composed (tuple) formats.  Per-client (n,) float64 (scalar counts
    broadcast); raises ValueError on a wire/counts structure mismatch."""
    if isinstance(wire, tuple):
        if not isinstance(counts, tuple) or isinstance(counts, Counts) \
                or len(wire) != len(counts):
            raise ValueError(
                f"composed wire has {len(wire)} legs but counts is "
                f"{type(counts).__name__} — every wire leg must be priced")
        return sum(price(w, c) for w, c in zip(wire, counts))
    dev = next((c.device for c in counts if isinstance(c, torch.Tensor)), None)
    return (_f64(counts.floats, dev) * wire.float_bits
            + _f64(counts.indices, dev) * wire.index_bits
            + _f64(counts.entries, dev) * wire.entry_bits)


def with_float_bits(wire: WireTree, float_bits: int) -> WireTree:
    """`wire` with every leg's per-float width replaced by `float_bits`."""
    if isinstance(wire, tuple):
        return tuple(with_float_bits(w, float_bits) for w in wire)
    return dataclasses.replace(wire, float_bits=float_bits)


#: float widths a shipped basis may quantize to: f64/f32 casts, bf16
#: round-trip, or int8 with per-column f32 scales (see `BasisShipSpec`).
_SHIP_FLOAT_BITS = (8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class BasisShipSpec:
    """How a shipped basis travels the wire (the ``basis_ship`` leg).

      * ``float_bits`` — per-value width: 64/32 are plain casts, 16 is a
        bfloat16 round-trip, 8 is symmetric int8 with one f32 scale per
        basis column (scales billed as 32-bit floats, the packed values as
        8-bit ``entries``);
      * ``col_frac`` — every basis column keeps its ``ceil(col_frac·rows)``
        largest magnitudes and ships them with their row indices.

    The default (f32, dense) prices exactly ``ship_floats() × 32``."""

    float_bits: int = 32
    col_frac: float = 1.0

    def __post_init__(self):
        if self.float_bits not in _SHIP_FLOAT_BITS:
            raise ValueError(
                f"BasisShipSpec.float_bits must be one of {_SHIP_FLOAT_BITS}"
                f" (f64/f32 cast, bf16, int8+scales), got {self.float_bits}")
        if not 0.0 < self.col_frac <= 1.0:
            raise ValueError(
                f"BasisShipSpec.col_frac must be in (0, 1], got {self.col_frac}")

    @property
    def dense(self) -> bool:
        return self.col_frac >= 1.0

    @property
    def wire(self) -> WireFormat:
        if self.float_bits == 8:
            return WireFormat(float_bits=32, index_bits=INDEX_BITS, entry_bits=8)
        return WireFormat(float_bits=self.float_bits, index_bits=INDEX_BITS)

    def factor_counts(self, rows: int, cols: int) -> Counts:
        """Message `Counts` of one shipped (rows, cols) factor, as python
        floats (shipment bits are priced once, at setup)."""
        kept_per_col = max(1, min(rows, int(math.ceil(self.col_frac * rows))))
        kept = float(kept_per_col * cols)
        idx = 0.0 if self.dense else kept
        if self.float_bits == 8:
            return Counts(floats=float(cols), indices=idx, entries=kept)
        return Counts(floats=kept, indices=idx)


@dataclasses.dataclass(frozen=True)
class CommLedger:
    """Cumulative per-leg bit counters (per-node averages) as float64
    scalars on the run's device.  `add` returns a new ledger."""

    hess_up: torch.Tensor
    grad_up: torch.Tensor
    model_down: torch.Tensor
    basis_ship: torch.Tensor

    LEGS = ("hess_up", "grad_up", "model_down", "basis_ship")

    @classmethod
    def create(cls, hess_up=0.0, grad_up=0.0, model_down=0.0, basis_ship=0.0,
               *, device=None):
        """Fresh ledger with optional initial per-leg bits."""
        return cls(_f64(hess_up, device), _f64(grad_up, device),
                   _f64(model_down, device), _f64(basis_ship, device))

    def add(self, hess_up=0.0, grad_up=0.0, model_down=0.0, basis_ship=0.0):
        return CommLedger(
            hess_up=self.hess_up + hess_up,
            grad_up=self.grad_up + grad_up,
            model_down=self.model_down + model_down,
            basis_ship=self.basis_ship + basis_ship,
        )

    def add_fleet_sums(self, n: int, **sums: float) -> "CommLedger":
        """Add per-node shares of fleet bit sums (host floats) to a host
        ledger: each leg becomes ``leg + sum·(1/n)`` rounded once, as the
        reference's compiled round computes it (a fused multiply-add by the
        rounded reciprocal), so the streams agree to the last bit for any
        n."""
        inv = 1.0 / n
        new = {leg: getattr(self, leg) for leg in self.LEGS}
        for leg, total in sums.items():
            old = new[leg]
            exact = Fraction(float(total)) * Fraction(inv) + Fraction(float(old))
            new[leg] = torch.tensor(float(exact), dtype=torch.float64, device=old.device)
        return CommLedger(**new)

    @property
    def uplink(self) -> torch.Tensor:
        """Total client→server bits (what the paper's x-axis plots)."""
        return self.hess_up + self.grad_up + self.basis_ship

    @property
    def downlink(self) -> torch.Tensor:
        return self.model_down

    @classmethod
    def stack(cls, ledgers) -> "CommLedger":
        """One ledger of per-round (steps,) streams from per-round ledgers
        (the counterpart of the reference's scan-stacked ledger)."""
        return cls(*(torch.stack([getattr(l, leg) for l in ledgers])
                     for leg in cls.LEGS))
