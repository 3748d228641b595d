"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — dense MHA decoder.

32L, d_model 4096, 32 heads (kv=32: full MHA), d_ff 13440 (SwiGLU),
vocab 92416.  Pure full attention ⇒ long_500k skipped.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    group=(LayerSpec(mixer="attn", ffn="mlp"),),
    rope_theta=1_000_000.0,
    max_seq=131_072,
)
