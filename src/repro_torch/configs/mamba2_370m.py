"""Mamba2-370m [arXiv:2405.21060] — SSD (state-space duality), attention-free.

48L, d_model 1024, d_inner 2048 (expand 2), 32 SSM heads × head_dim 64,
d_state 128, vocab 50280.  Sub-quadratic: runs long_500k.
"""
from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    n_layers=48,
    d_model=1024,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    group=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    subquadratic=True,
    max_seq=1_048_576,
)
