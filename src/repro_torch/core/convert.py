"""Carrying a problem across from the reference package.

`problem_from_numpy` takes the reference's problem as numpy arrays (client
data, the data basis, x0 and x*) and builds the port's objects from them,
so both packages run on the identical basis and optimum.  The port never
imports the reference: the caller converts its arrays with ``np.asarray``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .. import device as _device
from . import client_batch, glm
from .basis import DataOuterBasis


@dataclasses.dataclass
class ConvertedProblem:
    clients: List[glm.ClientData]
    bases: List[DataOuterBasis]
    batch: client_batch.ClientBatch
    basisb: client_batch.BatchedBasis
    x0: torch.Tensor
    x_star: torch.Tensor


def problem_from_numpy(A: np.ndarray, b: np.ndarray, lam: float, V: np.ndarray,
                       rs: Sequence[int], x0: np.ndarray, x_star: np.ndarray,
                       *, device=None) -> ConvertedProblem:
    """The port's problem from the reference's arrays, all float64:

    A (n, m, d) client data, b (n, m) labels, lam the ridge, V (n, d, r_max)
    the stacked data basis (columns beyond each client's rank zero, as the
    reference's `BatchedBasis` pads them), rs the per-client ranks, x0 and
    x_star (d,)."""
    dev = _device.resolve(device)

    def t(x):
        return torch.tensor(np.asarray(x, np.float64), device=dev)

    A, b, V = t(A), t(b), t(V)
    rs = tuple(int(r) for r in rs)
    if A.dim() != 3 or V.dim() != 3 or V.shape[:2] != (A.shape[0], A.shape[2]) \
            or len(rs) != A.shape[0] or max(rs) != V.shape[2]:
        raise ValueError(
            f"inconsistent shapes: A {tuple(A.shape)}, V {tuple(V.shape)}, "
            f"{len(rs)} ranks with max {max(rs) if rs else None}")
    clients = [glm.ClientData(A=A[i], b=b[i], lam=lam) for i in range(A.shape[0])]
    bases = [DataOuterBasis(V=V[i, :, :r]) for i, r in enumerate(rs)]
    return ConvertedProblem(
        clients=clients, bases=bases,
        batch=client_batch.ClientBatch(A=A, b=b, lam=lam),
        basisb=client_batch.BatchedBasis(kind="data_outer", d=A.shape[2], rs=rs, V=V),
        x0=t(x0), x_star=t(x_star))
