"""Hand-written Hopper kernels of the port, each beside its plain version.

``topk_threshold`` — exact per-row Top-K threshold, and the fused Top-K
compress-then-sum over a client stack (CUDA C++, sm_90a), replacing the
Pallas ``repro.kernels.topk_threshold.topk_row_threshold`` and
``topk_compress_sum``;
``tiled_matmul`` — batched tiled matrix product with float32 accumulation
(CUDA C++, sm_90a), replacing the Pallas
``repro.kernels.tiled_matmul.matmul``; ``ops`` builds Γ = VᵀAV and the GLM
Hessian on it;
``basis_transform`` — the two-sided rotation (A·gᵢ)·B over a client stack
(CUDA C++, sm_90a), replacing the Pallas
``repro.kernels.basis_transform.basis_transform``;
``flash_attention`` — masked softmax attention with an online softmax over
grouped-query heads (CUDA C++, sm_90a), replacing the Pallas
``repro.kernels.flash_attention.flash_attention``;
``ssd_scan`` — the Mamba2 SSD chunked scan with its final state (CUDA C++,
sm_90a), replacing the Pallas ``repro.kernels.ssd_scan.ssd_scan``.
Every Pallas kernel of the reference now has its counterpart here.
Three more kernels replace no Pallas kernel: the backward passes of kernels
5 and 6 (``flash_attention_bwd``, ``ssd_scan_bwd``), which training on the
card runs where the reference differentiates with jax.grad, and kernel 7,
``threefry_normal``: ``jax.random.normal``'s keyed draw (threefry-2x32 and
XLA's CPU inverse error function, bit for bit) written straight into a
weight leaf, and through its bits path every other threefry hash the port
makes on the card (``jax.random.split`` / ``fold_in`` / ``bits`` /
``uniform`` / ``bernoulli``), which the reference leaves to XLA.
"""

#: every CUDA source of the port, by its base name under ``csrc/``
SOURCES = ("topk_threshold", "topk_compress_sum", "tiled_matmul", "basis_transform",
           "flash_attention", "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd",
           "threefry_normal")
