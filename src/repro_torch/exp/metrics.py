"""Headline metrics derived from `History` streams — port of
`repro.exp.metrics`.

The paper's headline quantity is the communicated Mbits per node to reach
a target optimality gap (the x-axis of Fig. 1–6); `BitsToTol` carries the
reached/not-reached flag explicitly, so "diverged" and "slow" stay apart in
the artifacts.  Plain numpy on the host: the streams are Python floats.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BitsToTol(NamedTuple):
    """Mbits/node to reach a gap tolerance, plus whether it was reached.

    ``mbits`` is ``inf`` when the trajectory never dips below ``tol`` —
    consumers must branch on ``reached`` (a record with ``reached=False``
    may be a divergent run OR simply one that was stopped early)."""

    mbits: float
    reached: bool


def bits_to_tol(hist, tol: float = 1e-6) -> BitsToTol:
    """First cumulative uplink cost (Mbits/node) at which ``hist.gaps``
    drops below ``tol``.

    Args:
      hist: a `repro_torch.core.bl.History` (any object with ``gaps`` and
        ``up_bits`` sequences of equal length).
      tol: target optimality gap.

    Returns:
      `BitsToTol` — ``(mbits, reached)``; ``mbits == inf`` iff not reached.
    """
    g = np.asarray(hist.gaps, dtype=np.float64)
    up = np.asarray(hist.up_bits, dtype=np.float64)
    hit = g < tol
    if not hit.any():
        return BitsToTol(float("inf"), False)
    return BitsToTol(float(up[int(np.argmax(hit))]) / 1e6, True)


def best_gap_stream(gaps) -> np.ndarray:
    """Running best (monotone non-increasing) gap: cummin over rounds."""
    return np.minimum.accumulate(np.asarray(gaps, dtype=np.float64))
