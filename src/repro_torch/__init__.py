"""PyTorch/CUDA port of the Basis Learn library (`repro`), for NVIDIA H100.

The package mirrors `repro`'s layout (`core/`, `kernels/`, `exp/`, `fed/`,
`models/`, `configs/`, `launch/`) so each module has a named counterpart.  It imports torch and numpy only — never
JAX and nothing of `repro` — and keeps its own copies of what it needs.

Entry points take ``device=None``, which means ``"cuda"``: without a GPU
they raise instead of running on the CPU.  The CPU is used only when the
caller passes ``device="cpu"`` (the tests do), and then every kernel
wrapper takes its plain PyTorch version.

Ported so far (ROADMAP.md §1): BL1, Newton and FedNL on the single-device
fast path, BL-DNN, and the LM serving path (`launch.serve`: prefill and
greedy decode of gemma3-4b and mamba2-370m), with a hand-written CUDA
kernel for every Pallas kernel of the reference (`repro_torch.kernels`).
"""
