"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention, MoE.

72L in period-8 groups: 1 attention layer : 7 Mamba layers, MoE (16 experts,
top-2, d_expert 24576) every other layer and dense MLP (d_ff 24576) on the
rest — the source paper's exact interleave.  d_model 8192, 64 heads (kv=8),
vocab 65536.  Hybrid ⇒ runs long_500k (Mamba layers O(1) state; the 1-in-8
attention layers shard the 512k KV over the mesh).
"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    group=(
        LayerSpec(mixer="mamba", ffn="mlp"),
        LayerSpec(mixer="mamba", ffn="moe"),
        LayerSpec(mixer="mamba", ffn="mlp"),
        LayerSpec(mixer="mamba", ffn="moe"),
        LayerSpec(mixer="attn", ffn="mlp"),
        LayerSpec(mixer="mamba", ffn="moe"),
        LayerSpec(mixer="mamba", ffn="mlp"),
        LayerSpec(mixer="mamba", ffn="moe"),
    ),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=24576),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    subquadratic=True,
    max_seq=1_048_576,
)
