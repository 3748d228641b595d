"""Parameter / FLOP accounting for the roofline analysis — port of
`repro.models.analysis`."""
from __future__ import annotations

import math

from . import model as M
from .config import ModelConfig


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(t.shape) for t in _leaves(M.param_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: MoE counts only top_k + shared experts."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    mc = cfg.moe
    fe = mc.d_expert or cfg.d_ff
    n_moe_layers = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
    per_expert = 3 * cfg.d_model * fe
    inactive = n_moe_layers * (mc.n_experts - mc.top_k) * per_expert
    return total - inactive


def model_flops(cfg: ModelConfig, kind: str, global_batch: int, seq_len: int) -> float:
    """6·N_active·tokens for training, 2·N_active·tokens for inference.

    decode processes ONE token per sequence; prefill processes the full
    sequence.  (Attention's seq² term is excluded by convention.)
    """
    n = active_param_count(cfg)
    if kind == "train":
        return 6.0 * n * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch
