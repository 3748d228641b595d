"""The methods the paper compares against (§6, §A) — port of
`repro.core.baselines`, so far Newton (Table 1's naive and data-basis
columns).  GD, DIANA, ADIANA, Local-GD, NL1 and FedNL-BAG come with
ROADMAP.md §1 item 10; FedNL itself is `repro_torch.core.bl.bl1` with the
standard basis and a Rank-R Hessian compressor.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import glm
from .basis import MatrixBasis
from .bl import History, run_fast


def newton(
    clients: Sequence[glm.ClientData],
    x0: torch.Tensor,
    x_star: torch.Tensor,
    steps: int,
    bases: Optional[Sequence[MatrixBasis]] = None,
    backend: str = "auto",
    *,
    device=None,
    basis_project: str = "einsum",
) -> History:
    """Classical Newton.  ``bases=None`` sends d² + d floats a round
    (§2.1); per-client `DataOuterBasis` sends r² + r (§2.3, the §A.4
    comparison), after a one-time shipment of the basis.

    Args are the reference's (`repro.core.baselines.newton`), plus
    ``device`` (``None`` means ``"cuda"``, which raises without a GPU) and
    ``basis_project``, the route of Γ = VᵀAV: "einsum" (float64, the
    default) or "kernel" (float32 through the tiled-matmul kernel).
    "auto" and "fast" run the single-device fast path; bases of another
    kind raise `batched.FastPathUnavailable` under "fast" and
    `NotImplementedError` under "auto"."""
    from . import batched

    def fast(clients, bases, x0, x_star):
        return batched.newton_fast(clients, x0, x_star, steps, bases=bases,
                                   basis_project=basis_project)

    return run_fast(backend, device, clients, bases, x0, x_star, fast)
