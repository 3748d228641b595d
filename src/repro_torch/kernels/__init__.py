"""Hand-written Hopper kernels of the port, each beside its plain version.

``topk_threshold`` — exact per-row Top-K threshold (CUDA C++, sm_90a),
replacing the Pallas ``repro.kernels.topk_threshold.topk_row_threshold``.
The other Pallas kernels are queued in ROADMAP.md §2.
"""

#: every CUDA source of the port, by its base name under ``csrc/``
SOURCES = ("topk_threshold",)
