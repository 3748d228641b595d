"""Whisper-small [arXiv:2212.04356] — encoder–decoder audio backbone.

12L encoder + 12L decoder, d_model 768, 12 heads (MHA), d_ff 3072 (non-gated
GELU), vocab 51865.  The mel-spectrogram + conv frontend is a STUB:
input_specs provide precomputed frame embeddings (1500 frames = 30 s at the
model's 2× conv downsampling).  decode_32k exceeds the source card's
448-token context — exercised against the generic backbone as assigned.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    group=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=False,
    n_enc_layers=12,
    enc_seq=1500,
    max_seq=65_536,
)
