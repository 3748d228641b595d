"""Llama-4 Maverick 400B-A17B [hf:meta-llama] — MoE, early fusion.

48L, d_model 5120, 40 heads (kv=8), 128 routed experts top-1 + 1 shared
expert (d_expert 8192), interleaved with dense layers (d_ff 16384) every
other layer — the interleave matches the model card's 400B total / 17B
active; a uniform all-MoE reading of the flat config would give ~770B.
Early-fusion multimodality enters through the stubbed prefix
embeddings (text-only token path exercised here).
"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,                      # dense interleave layers
    vocab_size=202048,
    group=(
        LayerSpec(mixer="attn", ffn="moe"),
        LayerSpec(mixer="attn", ffn="mlp"),
    ),
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_expert=8192),
    rope_theta=500_000.0,
    max_seq=131_072,
)
