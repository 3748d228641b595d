"""The refusal shared by the kernels that have no backward."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise `RuntimeError` when grad mode is on and one of `tensors` needs
    a gradient: `kernel` has no backward (the reference's Pallas kernel has
    none either), and its CUDA output would carry none, so a gradient taken
    through it would be dropped without a word.  Checked before the device
    branch, so a CPU call refuses what a CUDA call would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: call it under torch.no_grad() or on "
                           f"tensors that do not require a gradient")
