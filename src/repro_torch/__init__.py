"""PyTorch/CUDA port of the Basis Learn library (`repro`), for NVIDIA H100.

The package mirrors `repro`'s layout (`core/`, `kernels/`, `exp/`, `fed/`,
`models/`, `configs/`, `launch/`) so each module has a named counterpart.  It imports torch and numpy only — never
JAX and nothing of `repro` — and keeps its own copies of what it needs.

Entry points take ``device=None``, which means ``"cuda"``: without a GPU
they raise instead of running on the CPU.  The CPU is used only when the
caller passes ``device="cpu"`` (the tests do), and then every kernel
wrapper takes its plain PyTorch version.

Ported so far (ROADMAP.md §1): the round engine with BL1/BL2/BL3 and the
baselines, the compressors, the basis registry and comm ledger, BL-DNN, the
experiment registry, the cohort engine, the service loop and the sharded
reducer; and the LM stack: all ten configs serve (`launch.serve`) and train
(`launch.train`), sharded over a `torch.distributed` mesh with the
reference's rules (`sharding`), and dry-run on the production mesh
(`launch.dryrun`); the program cache and its retrace audit
(`core.progcache`) and the op-by-op reference backend
(`core.bl_reference`).  Every Pallas kernel of the reference has a
hand-written CUDA kernel (`repro_torch.kernels`).
"""
