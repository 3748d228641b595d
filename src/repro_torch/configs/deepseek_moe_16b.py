"""DeepSeek-MoE 16B [arXiv:2401.06066] — fine-grained MoE.

28L, d_model 2048, 16 heads (MHA: kv=16), 64 routed experts top-6 with
d_expert=1408 + 2 shared experts, vocab 102400.  The source model's first
layer is a dense MLP; we keep all layers MoE for scan homogeneity
(parameter count matches within 2%).
"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    group=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    rope_theta=10_000.0,
    max_seq=131_072,
)
