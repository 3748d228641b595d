"""PyTorch/CUDA port of the Basis Learn library (`repro`), for NVIDIA H100.

The package mirrors `repro`'s layout (`core/`, `kernels/`, `exp/`) so each
module has a named counterpart.  It imports torch and numpy only — never
JAX and nothing of `repro` — and keeps its own copies of what it needs.

Entry points take ``device=None``, which means ``"cuda"``: without a GPU
they raise instead of running on the CPU.  The CPU is used only when the
caller passes ``device="cpu"`` (the tests do), and then every kernel
wrapper takes its plain PyTorch version.

Ported so far (ROADMAP.md §1 items 1–8): BL1 on the single-device fast
path with the ``standard`` / ``data_outer`` bases, the Identity and Top-K
compressors, and the exact Top-K threshold kernel
(`repro_torch.kernels.topk_threshold`).
"""
