"""Port of `repro.models`: the config dataclasses (`config`), the layer
library (`layers`: RMSNorm, RoPE, GQA attention with its KV cache, the
MLP, the Mamba2 mixer), model assembly (`model`), the prefill / decode step
factories (`steps`) and the carrying of reference parameters and caches
(`convert`).  MoE, M-RoPE, the encoder–decoder and training are ROADMAP.md
§1 item 18's later part."""
