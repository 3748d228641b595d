"""Granite-20B code [arXiv:2405.04324] — GPT-BigCode-style dense, MQA (kv=1).

52L, d_model 6144, 48 heads, kv=1, d_ff 24576 (non-gated GELU MLP),
vocab 49152.  Pure full attention ⇒ long_500k skipped
(`launch/shapes.py::shape_applicable`).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    group=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=False,
    max_seq=131_072,
)
