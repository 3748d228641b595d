"""The four assigned input shapes — port of `repro.launch.shapes` — and
the port's one-card serve shapes.

The reference's sharded ``*_struct`` input specs describe
inputs on a production mesh; they come with LM sharding (ROADMAP.md §1
item 18.7).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..models.config import ModelConfig


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
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic archs (skip rationale in each
    config's docstring)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: no sub-quadratic variant in source config"
    return True, ""


def _sharded(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"{name} builds sharded input specs on a production "
                                  f"mesh: ROADMAP.md §1 item 18.7 (LM sharding) brings it")
    stub.__name__ = name
    return stub


batch_struct = _sharded("batch_struct")
cache_struct = _sharded("cache_struct")
pos_struct = _sharded("pos_struct")
