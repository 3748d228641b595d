"""Model configuration — port of `repro.models.config` (the port keeps its
own copy; it imports nothing of `repro`).

Unified model configuration covering all assigned architecture families.

One `ModelConfig` describes dense GQA decoders, MoE decoders, Mamba2 (SSD)
stacks, hybrid attention/SSM interleaves (Jamba), encoder–decoder audio
backbones (Whisper) and VLM text backbones (M-RoPE).  Layer stacking is
expressed as a repeating *group pattern* so heterogeneous interleaves scan
over groups with the heterogeneity unrolled inside the group.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence, Tuple

MixerKind = Literal["attn", "mamba"]
FFNKind = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating group."""
    mixer: MixerKind = "attn"
    ffn: FFNKind = "mlp"
    #: attention window (tokens); None = full/global attention
    window: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0          # always-on shared experts (DeepSeek-MoE)
    d_expert: int = 0          # per-expert FFN width (0 ⇒ use d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 ⇒ d_model // n_heads
    group: Tuple[LayerSpec, ...] = (LayerSpec(),)  # repeats n_layers/len(group)×
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    #: gated (SwiGLU) vs plain 2-matrix MLP (GPT/Whisper style)
    mlp_gated: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    #: M-RoPE (Qwen2-VL): 3-component positions (temporal, h, w)
    mrope: bool = False
    #: encoder–decoder (Whisper): n_enc_layers of full-attention encoder over
    #: stub frame embeddings + cross-attention in every decoder layer
    n_enc_layers: int = 0
    enc_seq: int = 0                        # encoder positions (stub frames/patches)
    #: VLM stub: prepend this many precomputed patch embeddings to the text
    n_prefix_embeds: int = 0
    norm_eps: float = 1e-6
    #: supports sub-quadratic long-context decode (SSM/hybrid/sliding-window)
    subquadratic: bool = False
    max_seq: int = 131_072

    def __post_init__(self):
        assert self.n_layers % len(self.group) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by group "
            f"size {len(self.group)}"
        )

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so logits shard over `model`."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.group)

    @property
    def d_inner(self) -> int:  # SSM inner width
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def layer_specs(self) -> Sequence[LayerSpec]:
        return list(self.group) * self.n_groups

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: ≤2 groups, d_model ≤ 512, ≤4 experts."""
        group = self.group
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        hd = 64
        d_ff = min(self.d_ff, 512)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_expert=min(self.moe.d_expert, 128) if self.moe.d_expert else 0,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        # shrink window for smoke seq lengths
        group = tuple(
            dataclasses.replace(s, window=min(s.window, 8) if s.window else None)
            for s in group
        )
        kw = dict(
            name=self.name + "-smoke",
            n_layers=len(group) * min(self.n_groups, 2 if len(group) == 1 else 1),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=d_ff,
            vocab_size=min(self.vocab_size, 512),
            group=group,
            moe=moe,
            ssm=ssm,
            mlp_gated=self.mlp_gated,
            tie_embeddings=self.tie_embeddings,
            rope_theta=self.rope_theta,
            mrope=self.mrope,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 16),
            n_prefix_embeds=min(self.n_prefix_embeds, 4),
            norm_eps=self.norm_eps,
            subquadratic=self.subquadratic,
            max_seq=256,
        )
        kw.update(overrides)
        return ModelConfig(**kw)
