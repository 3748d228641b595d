"""Transformer layer library — port of the part of `repro.models.layers`
that BL-DNN's MLP classifier runs: the non-gated MLP block."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp(p: dict, x: torch.Tensor, gated: bool = False) -> torch.Tensor:
    """MLP block on (batch, seq, d) activations: ``gelu(x·wi)·wo``.  The
    reference's ``jax.nn.gelu`` is the tanh approximation by default, so
    this is too.  The gated (SiLU) variant comes with ROADMAP.md §1
    item 18."""
    if gated:
        raise NotImplementedError(
            "the gated MLP is not ported yet: ROADMAP.md §1 item 18 (LM stack) brings it")
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
