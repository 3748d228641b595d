"""Device resolution and the numeric policy for every port entry point."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means ``"cuda"``; a CUDA device without a GPU raises rather
    than falling back to the CPU.  The CPU runs only when asked for
    explicitly (``device="cpu"``), as the tests do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        # The reference computes in float64 and its kernels accumulate in
        # full float32; TF32 would keep ~10 mantissa bits in float32
        # products and convolutions and leave the parity envelope.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
