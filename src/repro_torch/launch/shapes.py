"""The four assigned input shapes — port of `repro.launch.shapes` — the
port's one-card serve and train shapes, and the input spec builders.

`batch_struct`, `cache_struct` and `pos_struct` describe a step's inputs
on a mesh without allocating anything: `Struct` records (global shape,
dtype, sharding spec), where the reference returns sharded
``jax.ShapeDtypeStruct`` records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..sharding.rules import Rules, cache_specs


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
    # one H100: decode_32k's KV cache alone (~80 GiB for gemma3-4b) does not
    # fit beside the weights, so the one-card serve cells run 4 (gemma3-4b)
    # or 8 (mamba2-370m) requests into a 4096-token cache
    "decode_4k_b4": InputShape("decode_4k_b4", 4_096, 4, "decode"),
    "decode_4k_b8": InputShape("decode_4k_b8", 4_096, 8, "decode"),
    # one H100: train_4k's 256 sequences are a pod's batch; one card holds
    # gemma3-4b's weights, gradients and bf16 AdamW moments (31 GB) beside the
    # fused cross entropy's float32 logits of one 4096-token sequence (4.3 GB
    # each for the logits and the softmax) and one rematerialised 17-layer
    # group, ~50 GB at its peak, and mamba2-370m's (~3.4 GB) beside those of 8
    # (its vocabulary is a fifth of gemma3's), ~25 GB: train_4k with the batch
    # cut from 256 to 1 and to 8, the sequence length kept
    "train_4k_b1": InputShape("train_4k_b1", 4_096, 1, "train"),
    "train_4k_b8": InputShape("train_4k_b8", 4_096, 8, "train"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic archs (skip rationale in each
    config's docstring)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: no sub-quadratic variant in source config"
    return True, ""


@dataclasses.dataclass(frozen=True)
class Struct:
    """A global tensor's shape, dtype and sharding spec (the counterpart of
    a sharded ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple


def batch_struct(cfg: ModelConfig, shape: InputShape, rules: Rules,
                 act_dtype=torch.bfloat16) -> Dict[str, Any]:
    B = shape.global_batch
    b = rules.spec(("batch",))[0]
    S = shape.seq_len + 1 if shape.kind == "train" else (
        shape.seq_len if shape.kind == "prefill" else 1)
    batch: Dict[str, Any] = {"tokens": Struct((B, S), torch.int32, (b, None))}
    if cfg.n_enc_layers:
        batch["frames"] = Struct((B, cfg.enc_seq, cfg.d_model), act_dtype, (b, None, None))
    if cfg.n_prefix_embeds and shape.kind != "decode":
        batch["prefix_embeds"] = Struct((B, cfg.n_prefix_embeds, cfg.d_model), act_dtype,
                                        (b, None, None))
    return batch


def cache_struct(cfg: ModelConfig, shape: InputShape, rules: Rules, dtype=torch.bfloat16):
    # prefill caches must also hold the stubbed VLM prefix embeddings
    max_seq = shape.seq_len
    if shape.kind == "prefill" and cfg.n_prefix_embeds:
        max_seq += cfg.n_prefix_embeds
    shapes = M.cache_shapes(cfg, shape.global_batch, max_seq, dtype)
    specs = cache_specs(shapes, cfg, rules)
    return {li: {k: Struct(tuple(t.shape), t.dtype, specs[li][k]) for k, t in leaves.items()}
            for li, leaves in shapes.items()}


def pos_struct(rules: Rules) -> Struct:
    return Struct((), torch.int32, ())
