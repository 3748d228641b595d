"""StableLM-2 12B [hf:stabilityai] — dense GQA decoder.

40L, d_model 5120, 32 heads (kv=8, head_dim 160), d_ff 13824 (SwiGLU),
vocab 100352.  Pure full attention ⇒ long_500k skipped.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    group=(LayerSpec(mixer="attn", ffn="mlp"),),
    max_seq=131_072,
)
