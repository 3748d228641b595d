"""Model assembly — port of `repro.models.model` for one device: parameter
init, the decode cache, and the train / prefill / decode forward.

Layers are stacked by *group* as in the reference: every leaf of
``params["layers"]`` and of the cache has a leading ``n_groups`` axis, and
the heterogeneity inside a group (gemma3's sliding/global pattern) is a
loop over the group's `LayerSpec`s.  The reference scans over groups; here
a Python loop walks them, indexing each group's slice of the stacked
leaves in place (a view, through which the gradient of the stacked leaf
flows).

MoE, encoder–decoder (cross-attention), prefix embeddings and M-RoPE are
ROADMAP.md §1 item 18's later part: `init_params` and `forward` raise for
configs that need them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..core import prng
from . import layers as L
from .config import LayerSpec, ModelConfig

Params = Dict[str, object]
_ITEM_18 = "is not ported yet: ROADMAP.md §1 item 18 (LM stack) brings it"


def _check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the parts of the reference model this
    slice does not run."""
    missing = [what for what, present in (
        ("MoE", cfg.moe is not None or any(s.ffn == "moe" for s in cfg.group)),
        ("the encoder–decoder (cross-attention)", cfg.n_enc_layers > 0),
        ("prefix embeddings", cfg.n_prefix_embeds > 0),
        ("M-RoPE", cfg.mrope)) if present]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} {_ITEM_18}")


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def _init_layer(key, spec: LayerSpec, cfg: ModelConfig, dtype, device) -> Params:
    ks = prng.split(key, 4).unbind(-2)
    lead = tuple(key.shape[:-1])
    p: Params = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, device, lead)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(ks[0], cfg, dtype, device)
    else:
        p["mamba"] = L.init_mamba(ks[0], cfg, dtype, device)
    if spec.ffn == "mlp":
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dtype, device, lead)
        p["mlp"] = L.init_mlp(ks[1], cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device)
    return p


def init_params(key: torch.Tensor, cfg: ModelConfig, dtype=torch.bfloat16, *,
                device=None) -> Params:
    """The reference's parameters (`model.init_params(key, cfg, dtype)`)
    bit for bit, drawn on `device`: the same key splits, and each weight
    `layers._init`'s ``jax.random.normal`` draw (`prng.normal`), scaled
    and cast as the reference's eager call rounds them.  ``key`` is a
    `prng.PRNGKey`.  Every stacked leaf (leading ``n_groups`` axis) is
    filled group by group from the group's own key, as the reference
    stacks its per-group trees."""
    _check_supported(cfg)
    dev = torch.device("meta") if str(device) == "meta" else _device.resolve(device)
    ks = prng.split(key, 6)
    p: Params = {"embed": L._init(ks[0], (cfg.padded_vocab, cfg.d_model), 0.02, dtype, dev),
                 "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = L._init(ks[1], (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5,
                               dtype, dev)
    # layer i of group g from split(split(ks[2], G)[g], len(group))[i]
    lkeys = prng.split(prng.split(ks[2], cfg.n_groups), len(cfg.group))   # (G, L, 2)
    p["layers"] = {f"l{i}": _init_layer(lkeys[:, i], spec, cfg, dtype, dev)
                   for i, spec in enumerate(cfg.group)}
    return p


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The parameter tree as meta tensors (shapes and types, no storage)."""
    return init_params(prng.PRNGKey(0), cfg, dtype, device="meta")


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()


# --------------------------------------------------------------------------
# Cache
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None) -> Params:
    """Per-group stacked decode caches (leading axis n_groups): K/V of
    ``min(max_seq, window)`` slots for a sliding-window layer (a ring) or
    `max_seq` for a global one; the conv tail and the float32 SSM state for
    a Mamba2 layer."""
    dev = _device.resolve(device)
    G = cfg.n_groups

    def layer_cache(spec: LayerSpec):
        if spec.mixer == "attn":
            s = min(max_seq, spec.window) if spec.window else max_seq
            shape = (G, batch, s, cfg.n_kv_heads, cfg.hd)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
        sc = cfg.ssm
        conv_dim = cfg.d_inner + 2 * sc.d_state
        return {"conv": torch.zeros((G, batch, sc.conv_width - 1, conv_dim), dtype=dtype,
                                    device=dev),
                "ssm": torch.zeros((G, batch, cfg.n_ssm_heads, sc.head_dim, sc.d_state),
                                   dtype=torch.float32, device=dev)}

    return {f"l{i}": layer_cache(s) for i, s in enumerate(cfg.group)}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------
def _index(tree, g: int):
    """Group `g`'s slice of every stacked leaf (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _apply_layer(lp: Params, spec: LayerSpec, cfg: ModelConfig, h: torch.Tensor,
                 pos: torch.Tensor, cache: Optional[Params], cache_pos) -> torch.Tensor:
    x = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    if spec.mixer == "attn":
        kv = (cache["k"], cache["v"]) if cache is not None else None
        out, _ = L.attention(lp["attn"], x, cfg, pos, window=spec.window, cache=kv,
                             cache_pos=cache_pos)          # writes the cache in place
    else:
        out, new_state = L.mamba(lp["mamba"], x, cfg, cache=cache)
        if cache is not None:
            cache["conv"].copy_(new_state["conv"])
            cache["ssm"].copy_(new_state["ssm"])
    h = h + out
    if spec.ffn == "mlp":
        h = h + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg.mlp_gated)
    return h


def _run_group(gp: Params, gc: Optional[Params], cfg: ModelConfig, h: torch.Tensor,
               pos: torch.Tensor, cache_pos) -> torch.Tensor:
    for i, spec in enumerate(cfg.group):
        h = _apply_layer(gp[f"l{i}"], spec, cfg, h, pos,
                         gc[f"l{i}"] if gc is not None else None, cache_pos)
    return h


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Optional[Params] = None, cache_pos: Optional[int] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, remat: bool = True,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits, cache, aux_loss) as the reference does.

    Modes: train (cache=None; logits at every position), prefill (cache
    given, S > 1, cache_pos 0; last-position logits), decode (cache given,
    S == 1, cache_pos the token's position).  The cache is updated in place
    and returned.  Logits of the padded vocabulary slots are −1e30.

    ``remat`` (train mode, when a gradient is being taken) runs each group
    under `torch.utils.checkpoint` (non-reentrant), so the backward
    recomputes a group's activations instead of keeping them, as the
    reference's ``jax.checkpoint(..., nothing_saveable)`` does.
    ``return_hidden`` returns the final-normed hidden states in place of the
    logits (the fused cross entropy's input)."""
    _check_supported(cfg)
    if prefix_embeds is not None or frames is not None:
        raise NotImplementedError(f"prefix embeddings and encoder frames {_ITEM_18}")
    B, S = tokens.shape
    h = p["embed"][tokens]
    if cfg.tie_embeddings:
        # the scale is cast to the activation type first, as the reference does
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    decode = cache is not None and S == 1
    if decode:
        pos = torch.full((B, 1), int(cache_pos), dtype=torch.int32, device=h.device)
    else:
        base = torch.arange(S, dtype=torch.int32, device=h.device)
        if cache_pos is not None:
            base = base + int(cache_pos)
        pos = base[None].expand(B, S)

    checkpointed = remat and cache is None and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        gp = _index(p["layers"], g)
        if checkpointed:
            h = checkpoint(_run_group, gp, None, cfg, h, pos, cache_pos, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _run_group(gp, _index(cache, g) if cache is not None else None, cfg, h, pos,
                           cache_pos)

    if cache is not None and not decode:
        h = h[:, -1:, :]           # prefill: only the last position's logits
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, cache, aux
    unemb = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = torch.einsum("bsd,dv->bsv", h, unemb)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)
    return logits, cache, aux
