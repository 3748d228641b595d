"""Model assembly — port of `repro.models.model`: parameter init, the
decode cache, and the train / prefill / decode forward, on one device or
on a rank's shards.

Layers are stacked by *group* as in the reference: every leaf of
``params["layers"]`` and of the cache has a leading ``n_groups`` axis, and
the heterogeneity inside a group (gemma3's sliding/global pattern) is a
loop over the group's `LayerSpec`s.  The reference scans over groups; here
a Python loop walks them, indexing each group's slice of the stacked
leaves in place (a view, through which the gradient of the stacked leaf
flows).

Encoder–decoder (Whisper): the encoder is a stack of non-causal attention
layers over the stub frame embeddings, and every decoder attention layer
adds cross-attention against its output.  VLM (Qwen2-VL): stub patch
embeddings are concatenated in front of the token embeddings and M-RoPE
positions are used.  MoE layers return the load-balance loss, summed over
the layers and returned as `forward`'s aux.

With sharding rules (`repro_torch.sharding.rules.Rules`) every function
works on this rank's shards: `init_params` draws the rank's shard of each
leaf by `param_specs` (the reference's bits), `init_cache` allocates the
rank's cache shards by `cache_specs` (a `ShardedCache` that carries them),
and `forward` runs the sharded layers (`layers`): the embedding
vocab-sharded (a masked local lookup, then an all-reduce over `model`) and
the logits vocab-sharded, this rank's vocabulary slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..core import prng
from ..kernels.threefry_normal import threefry_normal
from ..sharding import collectives as C
from ..sharding.rules import axes_of, cache_specs, param_specs
from . import layers as L
from .config import LayerSpec, ModelConfig

Params = Dict[str, object]


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def _init_layer(key, spec: LayerSpec, cfg: ModelConfig, dtype, device, draw) -> Params:
    ks = prng.split(key, 4).unbind(-2)
    lead = tuple(key.shape[:-1])
    p: Params = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, device, lead)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(ks[0], cfg, dtype, device, draw)
    else:
        p["mamba"] = L.init_mamba(ks[0], cfg, dtype, device, draw)
    if cfg.n_enc_layers and spec.mixer == "attn":
        p["ln_x"] = L.init_rmsnorm(cfg.d_model, dtype, device, lead)
        p["xattn"] = L.init_attention(ks[2], cfg, dtype, device, draw)
    if spec.ffn == "mlp":
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dtype, device, lead)
        p["mlp"] = L.init_mlp(ks[1], cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device, draw)
    elif spec.ffn == "moe":
        p["ln2"] = L.init_rmsnorm(cfg.d_model, dtype, device, lead)
        p["moe"] = L.init_moe(ks[1], cfg, dtype, device, draw)
    return p


def init_params(key: torch.Tensor, cfg: ModelConfig, dtype=torch.bfloat16, *,
                device=None, rules=None) -> Params:
    """The reference's parameters (`model.init_params(key, cfg, dtype)`)
    bit for bit, drawn on `device`: the same key splits, and each weight
    `layers._init`'s ``jax.random.normal`` draw (`prng.normal`), scaled
    and cast as the reference's eager call rounds them.  ``key`` is a
    `prng.PRNGKey`.  Every stacked leaf (leading ``n_groups`` axis) is
    filled group by group from the group's own key, as the reference
    stacks its per-group trees; the encoder's layers (stacked on a leading
    ``n_enc_layers`` axis) likewise.

    With `rules`, this rank's shard of each leaf by `param_specs`: a leaf
    sharded on its first dimension (after the group axis) draws only its
    window of the stream, any other draws a group at a time and keeps its
    part; the small leaves that are not drawn (norms, the SSM's A_log, D,
    dt_bias) are cut after."""
    dev = torch.device("meta") if str(device) == "meta" else _device.resolve(device)
    if rules is None:
        return _init_tree(key, cfg, dtype, dev, L._init)
    specs = dict(_flat(param_specs(param_shapes(cfg, dtype), cfg, rules)))
    tree = _init_tree(key, cfg, dtype, dev, _Draw)

    def local(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out[k] = (local(v, path) if isinstance(v, dict)
                      else v.shard(specs[path], rules.mesh) if isinstance(v, _Draw)
                      else local_part(v, specs[path], rules.mesh).clone())
        return out
    return local(tree)


def _init_tree(key, cfg: ModelConfig, dtype, dev, draw) -> Params:
    """The parameter tree, each drawn leaf made by ``draw(key, shape,
    scale, dtype, device)`` (`layers._init`, or `_Draw` to defer it)."""
    ks = prng.split(key, 6)
    p: Params = {"embed": draw(ks[0], (cfg.padded_vocab, cfg.d_model), 0.02, dtype, dev),
                 "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = draw(ks[1], (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5,
                            dtype, dev)
    # layer i of group g from split(split(ks[2], G)[g], len(group))[i]
    lkeys = prng.split(prng.split(ks[2], cfg.n_groups), len(cfg.group))   # (G, L, 2)
    p["layers"] = {f"l{i}": _init_layer(lkeys[:, i], spec, cfg, dtype, dev, draw)
                   for i, spec in enumerate(cfg.group)}
    if cfg.n_enc_layers:
        # encoder layer e from split(split(ks[3], n_enc)[e], 2): attention, MLP
        ekeys = prng.split(prng.split(ks[3], cfg.n_enc_layers), 2)          # (n_enc, 2, 2)
        lead = (cfg.n_enc_layers,)
        p["encoder"] = {
            "ln1": L.init_rmsnorm(cfg.d_model, dtype, dev, lead),
            "attn": L.init_attention(ekeys[:, 0], cfg, dtype, dev, draw),
            "ln2": L.init_rmsnorm(cfg.d_model, dtype, dev, lead),
            "mlp": L.init_mlp(ekeys[:, 1], cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, dev,
                              draw)}
        p["enc_pos"] = draw(ks[4], (cfg.enc_seq, cfg.d_model), 0.02, dtype, dev)
        p["enc_norm"] = L.init_rmsnorm(cfg.d_model, dtype, dev)
    return p


def local_part(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's part of a full tensor laid out by `spec`."""
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if axes:
            n = t.shape[d] // mesh.size(axes)
            t = t.narrow(d, mesh.index(axes) * n, n)
    return t


def local_shape(shape, spec, mesh) -> tuple:
    return tuple(n // mesh.size(axes_of(e)) for n, e in zip(shape, spec))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


class _Draw:
    """A `layers._init` draw not yet made: `shard` makes a rank's part of
    it, by the spec of the leaf's path."""

    def __init__(self, key, shape, scale, dtype, device):
        self.key, self.shape, self.scale = key, tuple(shape), scale
        self.dtype, self.device = dtype, device

    def shard(self, spec, mesh) -> torch.Tensor:
        k, shape, dt, dev = self.key, self.shape, self.dtype, self.device
        lead = tuple(k.shape[:-1])
        body = spec[len(lead):]
        out = torch.empty(lead + local_shape(shape, body, mesh), dtype=dt, device=dev)
        if dev.type == "meta":
            return out
        keys = k.reshape(-1, 2)
        n = math.prod(shape)
        s = float(torch.tensor(self.scale, dtype=torch.float32))
        cut = [d for d, e in enumerate(body) if axes_of(e)]
        if not cut:
            threefry_normal(out.view(-1, n), keys, n, scale=s)
        elif cut == [0]:
            # a contiguous window of the flat draw
            w = out[0].numel() if out.dim() > len(body) else out.numel()
            threefry_normal(out.view(-1, w), keys, n, start=mesh.index(axes_of(body[0])) * w,
                            scale=s)
        else:
            rows = out.view((-1,) + out.shape[len(lead):])
            for g in range(keys.shape[0]):
                full = torch.empty(shape, dtype=dt, device=dev)
                threefry_normal(full.view(1, n), keys[g:g + 1], n, scale=s)
                rows[g].copy_(local_part(full, body, mesh))
                del full
        return out


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
class ShardedCache(dict):
    """A rank's shards of the decode cache (the tree `init_cache` builds),
    with ``specs``, the `cache_specs` tree they were cut by."""

    specs: dict = {}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device=None, rules=None) -> Params:
    """Per-group stacked decode caches (leading axis n_groups): K/V of
    ``min(max_seq, window)`` slots for a sliding-window layer (a ring) or
    `max_seq` for a global one; the conv tail and the float32 SSM state for
    a Mamba2 layer.  With `rules`, this rank's shards (`ShardedCache`) by
    `cache_specs` of the global cache of `batch` sequences."""
    if rules is not None:
        specs = cache_specs(cache_shapes(cfg, batch, max_seq, dtype), cfg, rules)
        full = cache_shapes(cfg, batch, max_seq, dtype)
        dev = _device.resolve(device)
        out = ShardedCache({
            li: {k: torch.zeros(local_shape(t.shape, specs[li][k], rules.mesh), dtype=t.dtype,
                                device=dev) for k, t in leaves.items()}
            for li, leaves in full.items()})
        out.specs = specs
        return out
    dev = torch.device("meta") if str(device) == "meta" else _device.resolve(device)
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


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16) -> Params:
    """The global cache tree as meta tensors (reference `model.cache_shapes`)."""
    return init_cache(cfg, batch, max_seq, dtype, device="meta")


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------
def _index(tree, g: int):
    """Group `g`'s slice of every stacked leaf (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _at(rules, name: str, cache_spec=None):
    """`rules` scoped to `name` (None without rules); a stacked cache spec
    loses its group axis."""
    if rules is None:
        return None
    if cache_spec is not None:
        cache_spec = {k: v[1:] for k, v in cache_spec.items()}
    return rules.at(name, cache_spec)


def _apply_layer(lp: Params, spec: LayerSpec, cfg: ModelConfig, h: torch.Tensor,
                 pos: torch.Tensor, cache: Optional[Params], cache_pos,
                 enc_out: Optional[torch.Tensor], rules=None, cspec=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: (h, the MoE's aux loss, zero for another FFN).  `rules`
    is scoped to the layer (``layers/l{i}``), `cspec` its cache's specs."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    x = L.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    if spec.mixer == "attn":
        kv = (cache["k"], cache["v"]) if cache is not None else None
        out, _ = L.attention(lp["attn"], x, cfg, pos, window=spec.window, cache=kv,
                             cache_pos=cache_pos,   # writes the cache in place
                             rules=_at(rules, "attn", cspec))
    else:
        out, new_state = L.mamba(lp["mamba"], x, cfg, cache=cache,
                                 rules=_at(rules, "mamba", cspec))
        if cache is not None:
            cache["conv"].copy_(new_state["conv"])
            cache["ssm"].copy_(new_state["ssm"])
    h = L.shard_residual(rules, h + out)
    if enc_out is not None and spec.mixer == "attn" and "xattn" in lp:
        xp, xr = lp["xattn"], _at(rules, "xattn")
        out, _ = L.attention(xp, L.rmsnorm(lp["ln_x"], h, cfg.norm_eps), cfg, pos,
                             causal=False, kv_override=L.cross_kv(xp, enc_out, cfg, xr),
                             rules=xr)
        h = h + out
    if spec.ffn == "mlp":
        h = h + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg.mlp_gated,
                      _at(rules, "mlp"))
    elif spec.ffn == "moe":
        out, a = L.moe(lp["moe"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps), cfg,
                       _at(rules, "moe"))
        h = h + out
        aux = aux + a
    return L.shard_residual(rules, h), aux


def _run_group(gp: Params, gc: Optional[Params], cfg: ModelConfig, h: torch.Tensor,
               pos: torch.Tensor, cache_pos, enc_out: Optional[torch.Tensor], rules=None,
               cspecs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The group's layers in order: (h, the sum of their aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, spec in enumerate(cfg.group):
        h, a = _apply_layer(gp[f"l{i}"], spec, cfg, h, pos,
                            gc[f"l{i}"] if gc is not None else None, cache_pos, enc_out,
                            _at(rules, f"layers/l{i}"),
                            cspecs[f"l{i}"] if cspecs is not None else None)
        aux = aux + a
    return h, aux


def run_encoder(p: Params, cfg: ModelConfig, frames: torch.Tensor, rules=None) -> torch.Tensor:
    """The Whisper-style encoder over stub frame embeddings (B, enc_seq, D)
    (reference `model._run_encoder`): ``frames + enc_pos``, then each layer's
    non-causal self-attention (RoPE at positions 0 .. enc_seq − 1, kernel 5)
    and MLP, then the final norm."""
    h = frames + p["enc_pos"][None].to(frames.dtype)
    B, S = frames.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
    for e in range(cfg.n_enc_layers):
        ep = _index(p["encoder"], e)
        out, _ = L.attention(ep["attn"], L.rmsnorm(ep["ln1"], h, cfg.norm_eps), cfg, pos,
                             causal=False, rules=_at(rules, "encoder/attn"))
        h = h + out
        h = h + L.mlp(ep["mlp"], L.rmsnorm(ep["ln2"], h, cfg.norm_eps), cfg.mlp_gated,
                      _at(rules, "encoder/mlp"))
    return L.rmsnorm(p["enc_norm"], h, cfg.norm_eps)


def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor, rules) -> torch.Tensor:
    """Token embeddings; with `rules` over a vocab-sharded table, each
    rank looks up the tokens in its slice (zero elsewhere) and the rows are
    summed over `model`."""
    if rules is None or not axes_of(rules.leaf("embed")[0]):
        return p["embed"][tokens]
    table = p["embed"]
    v0 = rules.mesh.index("model") * table.shape[0]
    mine = (tokens >= v0) & (tokens < v0 + table.shape[0])
    rows = table[torch.where(mine, tokens - v0, 0)] * mine[..., None].to(table.dtype)
    return C.all_reduce(rows, rules.mesh, "model")


def vocab_slice(cfg: ModelConfig, rules) -> Tuple[int, int]:
    """(first id, count) of the vocabulary slice whose logits this rank holds."""
    if rules is not None:
        spec = rules.leaf("embed")[0] if cfg.tie_embeddings else rules.leaf("unembed")[1]
        if axes_of(spec):
            n = cfg.padded_vocab // rules.mesh.shape["model"]
            return rules.mesh.index("model") * n, n
    return 0, cfg.padded_vocab


def gather_logits(logits: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    """The logits over the whole vocabulary from this rank's slice (no
    gradient)."""
    if vocab_slice(cfg, rules)[1] == cfg.padded_vocab:
        return logits
    return C.gather_to(logits, rules.mesh, (None, None, "model"))


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Optional[Params] = None, cache_pos: Optional[int] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, remat: bool = True,
            return_hidden: bool = False, rules=None
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (logits, cache, aux_loss) as the reference does.

    Modes: train (cache=None; logits at every position), prefill (cache
    given, S > 1, cache_pos 0; last-position logits), decode (cache given,
    S == 1, cache_pos the token's position).  The cache is updated in place
    and returned.  Logits of the padded vocabulary slots are −1e30.

    ``prefix_embeds`` (B, P, D) go in front of the token embeddings, and
    the positions run over P + S (a prefill writes P + S cache slots, so
    decode continues at P + S).  M-RoPE configs take the positions as three
    equal components.  An encoder–decoder config needs ``frames`` (B,
    enc_seq, D) on every call, decode steps included: the encoder runs on
    each, as in the reference.  ``aux_loss`` is the MoE layers' summed
    load-balance loss (float32; zero without MoE): summed a group in layer
    order, then over the groups.

    ``remat`` (train mode, when a gradient is being taken) runs each group
    under `torch.utils.checkpoint` (non-reentrant), so the backward
    recomputes a group's activations instead of keeping them, as the
    reference's ``jax.checkpoint(..., nothing_saveable)`` does.
    ``return_hidden`` returns the final-normed hidden states in place of the
    logits (the fused cross entropy's input).

    With `rules` (`Rules`, bound here to the config when it is not yet),
    `p` holds this rank's parameter shards, `tokens` (and the frames and
    prefix embeddings) this rank's batch rows, and `cache` its cache shards
    (`init_cache(..., rules=)`); the logits are this rank's rows over its
    vocabulary slice (`vocab_slice`, `gather_logits`) and the aux loss the
    layers' (replicated)."""
    if rules is not None and rules.table is None:
        rules = rules.bind(cfg)
    B, S = tokens.shape
    h = _embed(p, cfg, tokens, rules)
    if cfg.tie_embeddings:
        # the scale is cast to the activation type first, as the reference does
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    S = h.shape[1]
    decode = cache is not None and S == 1
    if decode:
        pos = torch.full((B, 1), int(cache_pos), dtype=torch.int32, device=h.device)
    else:
        base = torch.arange(S, dtype=torch.int32, device=h.device)
        if cache_pos is not None:
            base = base + int(cache_pos)
        pos = base[None].expand(B, S)
    if cfg.mrope:
        pos = pos[None].expand(3, B, S)
    enc_out = None
    if cfg.n_enc_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder–decoder: forward needs its frames "
                             f"(batch, {cfg.enc_seq}, {cfg.d_model}) on every call")
        enc_out = run_encoder(p, cfg, frames, rules)
    h = L.shard_residual(rules, h)
    cspecs = getattr(cache, "specs", None) if rules is not None else None

    checkpointed = remat and cache is None and torch.is_grad_enabled()
    auxs = []
    for g in range(cfg.n_groups):
        gp = _index(p["layers"], g)
        if checkpointed:
            h, aux = checkpoint(_run_group, gp, None, cfg, h, pos, cache_pos, enc_out, rules,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            h, aux = _run_group(gp, _index(cache, g) if cache is not None else None, cfg, h,
                                pos, cache_pos, enc_out, rules, cspecs)
        auxs.append(aux)

    if cache is not None and not decode:
        h = h[:, -1:, :]           # prefill: only the last position's logits
    h = L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
    aux = torch.stack(auxs).sum()
    if return_hidden:
        return h, cache, aux
    unemb = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    v0, nv = vocab_slice(cfg, rules)
    if nv != cfg.padded_vocab:
        h = C.enter(h, rules.mesh, "model")
    elif rules is not None:
        unemb = L.weight(rules, unemb.T if cfg.tie_embeddings else unemb,
                         rules.leaf("embed" if cfg.tie_embeddings else "unembed"),
                         use="replicated")
        unemb = unemb.T if cfg.tie_embeddings else unemb
    logits = torch.einsum("bsd,dv->bsv", h, unemb)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(v0, v0 + nv, device=h.device) >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)
    return logits, cache, aux
