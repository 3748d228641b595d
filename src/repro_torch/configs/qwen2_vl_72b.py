"""Qwen2-VL-72B [arXiv:2409.12191] — VLM text backbone with M-RoPE.

80L, d_model 8192, 64 heads (kv=8), d_ff 29568 (SwiGLU), vocab 152064.
The ViT/dynamic-resolution frontend is a STUB: input_specs provide 256
precomputed patch embeddings per sample; M-RoPE (3-section rotary) is the
real mechanism exercised.  Pure full attention ⇒ long_500k skipped.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    group=(LayerSpec(mixer="attn", ffn="mlp"),),
    mrope=True,
    n_prefix_embeds=256,
    rope_theta=1_000_000.0,
    max_seq=131_072,
)
