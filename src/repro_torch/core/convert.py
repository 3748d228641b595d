"""Carrying a problem across from the reference package.

`problem_from_numpy` takes the reference's GLM problem as numpy arrays
(client data, the data basis, x0 and x*) and builds the port's objects
from them, so both packages run on the identical basis and optimum.
`dnn_problem_from_numpy` does the same for BL-DNN: data, the student's
parameters and the per-layer SVD factors.  The port never imports the
reference: the caller converts its arrays with ``np.asarray``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from . import client_batch, glm
from .basis import DataOuterBasis, PerLayerSVDBasis
from .pytree import tree_leaves, tree_map


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


@dataclasses.dataclass
class ConvertedDNN:
    batch: client_batch.TreeBatch
    params0: dict
    basis: PerLayerSVDBasis


def dnn_problem_from_numpy(x: np.ndarray, y: np.ndarray, params: dict,
                           UV: Sequence[Optional[Tuple[np.ndarray, np.ndarray]]],
                           *, device=None) -> ConvertedDNN:
    """The port's BL-DNN problem from the reference's arrays:

    x (n, m, d) float32 features, y (n, m) int32 labels, ``params`` the
    student's parameter tree as nested dicts of float32 arrays, and ``UV``
    the reference's per-layer SVD factors in its leaf order (sorted keys):
    ``(U, V)`` for a rotated leaf, None for a pass-through one.  The factors
    of a rank-deficient weight are not unique, so a run that must match the
    reference rotates with the reference's own."""
    dev = _device.resolve(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    params0 = tree_map(f32, params)
    leaves = tree_leaves(params0)
    if len(UV) != len(leaves):
        raise ValueError(f"{len(UV)} basis entries for {len(leaves)} parameter leaves")
    factors = []
    for p, uv in zip(leaves, UV):
        if uv is None:
            factors.append(None)
            continue
        U, V = f32(uv[0]), f32(uv[1])
        if p.dim() != 2 or U.shape != (p.shape[0],) * 2 or V.shape != (p.shape[1],) * 2:
            raise ValueError(f"factors {tuple(U.shape)}, {tuple(V.shape)} do not "
                             f"rotate a leaf of shape {tuple(p.shape)}")
        factors.append((U, V))
    data = {"x": f32(x), "y": torch.tensor(np.asarray(y, np.int32), device=dev)}
    return ConvertedDNN(batch=client_batch.tree_batch(data), params0=params0,
                        basis=PerLayerSVDBasis(UV=tuple(factors)))
