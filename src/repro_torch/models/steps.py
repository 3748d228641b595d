"""Prefill / decode step factories — port of the serving part of
`repro.models.steps`.

Each factory closes over the config and returns a plain function.  The
reference's factories also take sharding rules; the port runs the LM on
one device and has none (LM sharding is ROADMAP.md §1 item 18.7).  The train step, the fused
vocabulary-parallel cross entropy and AdamW are ROADMAP.md §1 item 18's
later part.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import device as _device
from . import model as M
from .config import ModelConfig

_ITEM_18 = "is not ported yet: ROADMAP.md §1 item 18 (train step, AdamW) brings it"


def stub_inputs(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                device=None) -> Dict[str, torch.Tensor]:
    """Extra (non-token) model inputs of the audio/VLM backbones' stub
    frontends, as zeros; empty for the decoder-only configs."""
    dev = _device.resolve(device)
    extras: Dict[str, torch.Tensor] = {}
    if cfg.n_enc_layers:
        extras["frames"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                                       device=dev)
    if cfg.n_prefix_embeds:
        extras["prefix_embeds"] = torch.zeros((batch, cfg.n_prefix_embeds, cfg.d_model),
                                              dtype=dtype, device=dev)
    return extras


def make_train_step(*args, **kwargs):
    raise NotImplementedError(f"make_train_step {_ITEM_18}")


def make_fused_vocab_xent(*args, **kwargs):
    raise NotImplementedError(f"make_fused_vocab_xent {_ITEM_18}")


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch, cache) -> (last-position logits,
    cache)``, positions 0 .. S−1."""
    def prefill_step(params, batch, cache):
        logits, cache, _ = M.forward(params, cfg, batch["tokens"], cache=cache, cache_pos=0,
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     frames=batch.get("frames"))
        return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, return_logits: bool = False):
    """One decode step, ``serve_step(params, batch, cache, pos) ->
    (next_tok, cache)``: next-token logits at position `pos`, greedy
    argmax as int32, the cache updated.  With ``return_logits`` the step
    also returns the (B, 1, V) logits."""
    def serve_step(params, batch, cache, pos):
        logits, cache, _ = M.forward(params, cfg, batch["tokens"], cache=cache,
                                     cache_pos=pos, frames=batch.get("frames"))
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return (next_tok, cache, logits) if return_logits else (next_tok, cache)

    return serve_step
