"""Port of `repro.models`: the config dataclasses (`config`), the layer
library (`layers`: RMSNorm, RoPE and M-RoPE, GQA attention with its KV
cache, the MLP, the MoE, the Mamba2 mixer, each also on a rank's shards),
model assembly with the Whisper encoder–decoder and prefix embeddings
(`model`), the train / prefill / decode step factories (`steps`), parameter
and FLOP accounting (`analysis`) and the carrying of reference parameters
and caches (`convert`)."""
