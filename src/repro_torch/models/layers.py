"""Transformer layer library — port of `repro.models.layers` for one device:
RMSNorm, RoPE and M-RoPE, GQA attention with its KV cache (full or ring)
and cross-attention, the MLP (gated SwiGLU or plain GELU), the MoE
(top-k token choice with capacity, shared experts) and the Mamba2 SSD
mixer, with the parameter initialisers at the reference's shapes and
scales.

Functions are plain functions on tensors and parameters are nested dicts
of tensors with the reference's names, so each has an obvious counterpart
in `repro.models.layers`.  Full-sequence attention goes through
`kernels.ops.attention` (kernel 5) and the full-sequence SSD through
`kernels.ops.ssd` (kernel 6); the single-token decode branches are the
reference's plain einsums.  Caches are updated in place and returned (the
reference's functional updates would copy the whole cache every step).
The train branches (no cache) write nothing in place, so autograd
differentiates them; on CUDA tensors kernels 5 and 6 run there through
their autograd Functions, and the Mamba2 block's float32 `A_log`, `D` and
`dt_bias` get their gradients through them (A = −exp(A_log) feeds kernel
6's dA).  The MoE is the reference's global path (`layers.moe`) without
sharding rules.

With sharding rules (`repro_torch.sharding.rules.Rules`, bound to the
config and scoped to the layer's parameters) every function computes the
reference's GSPMD result on this rank's local shards, with the collectives
of `repro_torch.sharding.collectives` where the reference's program moves
data: attention with its heads over `model` (the `wo` product all-reduced),
or sequence-parallel attention (kernel 5 at the rank's query offset) where
the heads do not divide `model`; decode over a sequence-sharded KV cache
(each rank attends over its keys, the partial softmaxes combined); the MLP
with its hidden width over `model`; the expert-parallel MoE
(`_moe_expert_parallel`) or the global route over the gathered batch; the
Mamba2 mixer with its SSM heads over `model`; parameters all-gathered over
`data` where they are used (FSDP), their gradients reduce-scattered.
Activations follow one convention: a tensor replicated over `model` has
the same gradient on every rank, and a replicated tensor that enters a
computation each rank does on its own part goes through
`collectives.enter` (its gradient summed over the ranks).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import prng, xla_math
from ..kernels import ops
from ..kernels.threefry_normal import threefry_normal
from ..sharding import collectives as C
from ..sharding.rules import axes_of, data_axes
from .config import ModelConfig

Params = Dict[str, object]
_NEG = -1e30
def _init(key: torch.Tensor, shape, scale, dtype, device) -> torch.Tensor:
    """``(jax.random.normal(key, shape, float32) * scale).astype(dtype)``
    (reference `layers._init`), bit for bit: the draws are `prng.normal`'s,
    the scale rounds to float32 (a weakly typed Python float) and the cast
    rounds to nearest even.  A batch of keys (..., 2) draws a stacked leaf
    (..., *shape), one draw a key, as the reference stacks per-group draws.
    The draws are written straight into the leaf by
    `kernels.threefry_normal` (one launch of kernel 7 a leaf on the card;
    on the CPU its plain version, `prng.normal_chunks`' pieces), so no
    float32 copy of a whole leaf is held.  The ``init_*`` functions take
    it as their ``draw`` (`model.init_params` passes another to draw a
    rank's shards)."""
    lead = tuple(key.shape[:-1])
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=device)
    if device.type == "meta":
        return out
    s = float(torch.tensor(scale, dtype=torch.float32))
    n = math.prod(shape)
    if n and out.numel():
        threefry_normal(out.view(-1, n), key.reshape(-1, 2), n, scale=s)
    return out


# --------------------------------------------------------------------------
# Sharding
# --------------------------------------------------------------------------
def shard(rules, x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's logical-axis sharding constraint.  The port computes
    on local shards, which already have the layout the constraint asks for,
    so it only checks the rank of `x`."""
    if rules is not None and x.dim() != len(axes):
        raise ValueError(f"a constraint over {axes} on a tensor of shape {tuple(x.shape)}")
    return x


def shard_residual(rules, h: torch.Tensor) -> torch.Tensor:
    """Residual stream: batch-sharded, replicated over `model` — on each
    rank, its batch rows at full width."""
    return shard(rules, h, "batch", None, None)


def _msize(rules) -> int:
    return 1 if rules is None else rules.mesh.shape["model"]


def _batch_shards(rules) -> int:
    return rules.mesh.size(axes_of(rules.amap["batch"]))


def weight(rules, t: torch.Tensor, spec, keep_model: bool = False,
           use: str = "partial") -> torch.Tensor:
    """A parameter's local shard `t` (laid out by `spec`) as a computation
    uses it: gathered over the data axes where FSDP shards it (the gradient
    reduce-scattered), and over `model` unless `keep_model` (a computation
    on this rank's part of that dimension).  ``use="partial"``: the
    model-wide weight feeds a computation of this rank's own (its gradient
    summed over `model`); ``"replicated"``: every rank computes alike."""
    mesh = rules.mesh
    sharded_model = False
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        if "model" in axes:
            sharded_model = True
            if not keep_model:
                t = C.all_gather(t, mesh, axes, d, bwd="sum" if use == "partial" else "slice")
        else:
            t = C.all_gather(t, mesh, axes, d, bwd="sum")
    if not sharded_model and use == "partial":
        t = C.enter(t, mesh, "model")
    return t


def _model_split(rules, n: int) -> Tuple[int, int]:
    """(first index, count) of this rank's part of n things over `model`."""
    m = _msize(rules)
    return rules.mesh.index("model") * (n // m), n // m


# --------------------------------------------------------------------------
# Norm
# --------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device, lead: tuple = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def _f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, the reference's upcast; float64 stays float64, so
    that a float64 run of the norms and the Mamba2 block (the sharded
    path's rounding witness in the CPU tests) rounds nowhere to float32."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS normalisation in float32, cast back to the input type."""
    h = _f32(x)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * _f32(p["scale"])).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd // 2, dtype=torch.float32, device=device)
                            * 2.0 / hd))


def mrope_sections(hd: int) -> list:
    """M-RoPE's split of the hd/2 frequency slots into (temporal, height,
    width) sections: ``[n − 2⌊n/3⌋, ⌊n/3⌋, ⌊n/3⌋]`` for n = hd/2."""
    n = hd // 2
    return [n - 2 * (n // 3), n // 3, n // 3]


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """Rotary position embedding of x (B, S, H, hd) at positions pos (B, S),
    rotate-half convention (the two halves of hd, not interleaved pairs),
    computed in float32.  M-RoPE (Qwen2-VL) takes pos (3, B, S): frequency
    slot f turns by the position component of its section
    (`mrope_sections`) times its frequency, one float32 product as in the
    reference; with three equal components it is 1-D RoPE."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if mrope:
        if pos.dim() != 3 or pos.shape[0] != 3:
            raise ValueError(f"M-RoPE takes positions (3, batch, seq); got {tuple(pos.shape)}")
        # each frequency slot's component, built on the host (a repeat by a
        # tensor of counts has a data-dependent size, which fake tensors refuse)
        comp = torch.tensor([c for c, n in enumerate(mrope_sections(hd)) for _ in range(n)],
                            device=pos.device)
        ang = pos.float()[comp].permute(1, 2, 0) * freqs           # (B, S, hd/2)
    else:
        if pos.dim() == 3:
            pos = pos[0]
        ang = pos.float()[:, :, None] * freqs[None, None, :]      # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def init_attention(key, cfg: ModelConfig, dtype, device, draw=_init) -> Params:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ks = prng.split(key, 4).unbind(-2)
    s = d ** -0.5
    return {
        "wq": draw(ks[0], (d, nh, hd), s, dtype, device),
        "wk": draw(ks[1], (d, nkv, hd), s, dtype, device),
        "wv": draw(ks[2], (d, nkv, hd), s, dtype, device),
        "wo": draw(ks[3], (nh, hd, d), (nh * hd) ** -0.5, dtype, device),
    }


def _write_seq(buf: torch.Tensor, val: torch.Tensor, start: int) -> None:
    """``buf[:, start:start+len] = val`` in place, the start clamped so the
    update fits, as `jax.lax.dynamic_update_slice` clamps it."""
    n = val.shape[1]
    start = min(max(int(start), 0), buf.shape[1] - n)
    buf[:, start:start + n] = val.to(buf.dtype)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor,
              window: Optional[int] = None,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None,
              causal: bool = True,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              *, rules=None) -> Tuple[torch.Tensor, Optional[tuple]]:
    """GQA attention (reference `layers.attention`).

    * train (cache=None): full-sequence attention through kernel 5.
    * prefill (cache given, Sq > 1): the same, and K/V are written into the
      cache at `cache_pos`, or, when Sq ≥ the cache length Sc, the last Sc
      tokens at slot 0 (a ring cache of a sliding-window layer; Sq must then
      be a multiple of Sc).
    * decode (cache given, Sq == 1): the token's K/V go to slot
      ``cache_pos % Sc`` of a ring cache (Sc ≤ window) or ``cache_pos`` of a
      full one, and the query attends over the cache within the window.
    * cross-attention: ``kv_override = (k, v)``, (B, Sk, KVH, hd) computed
      from the encoder's output; q gets no RoPE, no cache is written, every
      key is visible, and kernel 5 runs at every Sq (decode's 1 included),
      as the reference's `_blocked_attn` does.
    The cache is written in place and returned as ``(K, V)``.  A window
    applies to causal attention only: the reference masks non-causal
    attention with all ones but still slices each query block's window
    stripe, so the pair has no one function, and it raises here.

    With `rules` (scoped to the layer's attention parameters, and to its
    cache specs when a cache is given) it runs on this rank's shards
    (`_attention_sharded`); a cross-attention's ``kv_override`` then comes
    from `cross_kv` with the same rules."""
    if window is not None and not causal:
        raise ValueError("a sliding window applies to causal attention only")
    if rules is not None:
        return _attention_sharded(p, x, cfg, pos, window, cache, cache_pos, causal,
                                  kv_override, rules)
    B, Sq, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = nh // nkv

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if kv_override is not None:
        o = ops.attention(q, *kv_override, causal=False)
        return torch.einsum("bqhd,hdm->bqm", o, p["wo"]), None
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope)

    new_cache = None
    if cache is not None:
        K, V = cache
        Sc = K.shape[1]
        ring = window is not None and Sc <= window
        if Sq == 1:
            slot = cache_pos % Sc if ring else cache_pos
            _write_seq(K, k, slot)
            _write_seq(V, v, slot)
        elif Sq >= Sc:
            if Sq % Sc:
                raise ValueError(f"a prefill of {Sq} tokens into a cache of {Sc} slots "
                                 f"must be a multiple of it (reference layers.py:289-290)")
            _write_seq(K, k[:, Sq - Sc:], 0)
            _write_seq(V, v[:, Sq - Sc:], 0)
        else:
            _write_seq(K, k, cache_pos)
            _write_seq(V, v, cache_pos)
        new_cache = (K, V)

    if cache is not None and Sq == 1:
        K, V = new_cache
        Sk = K.shape[1]
        k_idx = torch.arange(Sk, device=x.device)
        if window is not None and Sk <= window:
            # ring: slot s holds position cache_pos − ((cache_pos − s) mod Sk)
            valid = cache_pos - torch.remainder(cache_pos - k_idx, Sk) >= 0
        else:
            valid = k_idx <= cache_pos
            if window is not None:
                valid = valid & (k_idx > cache_pos - window)
        qg = q.reshape(B, 1, nkv, rep, hd)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float() * hd ** -0.5, K.float())
        s = torch.where(valid, s, _NEG)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", pr.to(V.dtype), V).reshape(B, 1, nh, hd)
    else:
        o = ops.attention(q, k, v, causal=causal, window=window)

    return torch.einsum("bqhd,hdm->bqm", o, p["wo"]), new_cache


def attn_mode(cfg: ModelConfig, rules, Sq: int, decode: bool, cross: bool) -> str:
    """How a sharded attention call splits its work over `model`:
    ``"decode"`` (one token over a sequence-sharded cache), ``"heads"``
    (n_heads divides `model`), ``"seq"`` (sequence-parallel: the
    reference's gate at `layers.py:328-333`) or ``"replicated"``."""
    m = _msize(rules)
    if decode:
        return "decode"
    if cfg.n_heads % m == 0:
        return "heads"
    if not cross and Sq % m == 0 and Sq >= 4 * m:
        return "seq"
    return "replicated"


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig, rules=None) -> tuple:
    """A cross-attention's (k, v), (B, enc_seq, KVH, hd), from the encoder's
    output: every KV head, laid out for `attention`'s sharded mode."""
    if rules is None:
        return (torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]),
                torch.einsum("bsd,dhk->bshk", enc_out, p["wv"]))
    use = "partial" if attn_mode(cfg, rules, 0, False, True) == "heads" else "replicated"
    e = C.enter(enc_out, rules.mesh, "model") if use == "partial" else enc_out
    return tuple(torch.einsum("bsd,dhk->bshk", e, weight(rules, p[n], rules.leaf(n), use=use))
                 for n in ("wk", "wv"))


def _kv_heads_of(k: torch.Tensor, h0: int, nh_loc: int, rep: int) -> torch.Tensor:
    """The KV heads that query heads [h0, h0 + nh_loc) read, laid out so
    kernel 5's grouping (``h // (H / KVH)``) finds them."""
    if nh_loc % rep == 0:
        return k.narrow(2, h0 // rep, nh_loc // rep)
    if rep % nh_loc == 0:
        return k.narrow(2, h0 // rep, 1)
    idx = torch.arange(h0, h0 + nh_loc, device=k.device) // rep
    return k[:, :, idx]


def _cache_axes(rules) -> tuple:
    """The mesh axes the scope's K/V cache shards its sequence over."""
    return axes_of(rules.cache["k"][1])


def _write_cache_sharded(rules, cache, k, v, Sq, window, cache_pos) -> None:
    """Write this rank's slots of the global cache update (the reference's
    `dynamic_update_slice` on the whole cache): a decode token's K/V at its
    slot, a prefill's at ``cache_pos`` or its last Sc at slot 0."""
    K, V = cache
    axes = _cache_axes(rules)
    Sl = K.shape[1]
    Sc = Sl * rules.mesh.size(axes)
    c0 = rules.mesh.index(axes) * Sl
    ring = window is not None and Sc <= window
    if Sq == 1:
        start = cache_pos % Sc if ring else cache_pos
    elif Sq >= Sc:
        if Sq % Sc:
            raise ValueError(f"a prefill of {Sq} tokens into a cache of {Sc} slots "
                             f"must be a multiple of it (reference layers.py:289-290)")
        k, v, start = k[:, Sq - Sc:], v[:, Sq - Sc:], 0
    else:
        start = cache_pos
    n = k.shape[1]
    start = min(max(int(start), 0), Sc - n)
    lo, hi = max(start, c0), min(start + n, c0 + Sl)
    if lo < hi:
        K[:, lo - c0:hi - c0] = k[:, lo - start:hi - start].to(K.dtype)
        V[:, lo - c0:hi - c0] = v[:, lo - start:hi - start].to(V.dtype)


def _decode_attend(rules, qg, K, V, window, cache_pos) -> torch.Tensor:
    """One query token (B, 1, KVH, rep, hd) over a sequence-sharded cache:
    each rank's masked softmax over its keys, as (max, sum, weighted
    values), combined over the cache's sequence axes in rank order.
    Returns (B, 1, KVH·rep, hd)."""
    axes = _cache_axes(rules)
    B, _, G, rep, hd = qg.shape
    Sl = K.shape[1]
    Sk = Sl * rules.mesh.size(axes)
    k_idx = rules.mesh.index(axes) * Sl + torch.arange(Sl, device=K.device)
    if window is not None and Sk <= window:
        valid = cache_pos - torch.remainder(cache_pos - k_idx, Sk) >= 0
    else:
        valid = k_idx <= cache_pos
        if window is not None:
            valid = valid & (k_idx > cache_pos - window)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float() * hd ** -0.5, K.float())
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    part = torch.cat([m, e.sum(dim=-1, keepdim=True),
                      torch.einsum("bgrqk,bkgd->bgrqd", e.to(V.dtype), V).float()], dim=-1)
    if rules.mesh.size(axes) > 1:
        parts = C.all_gather(part[None], rules.mesh, axes, 0)
        mx = parts[..., :1].amax(dim=0)
        w = torch.exp(parts[..., :1] - mx)
        num, den = w[0] * parts[0, ..., 2:], w[0] * parts[0, ..., 1:2]
        for i in range(1, parts.shape[0]):
            num = num + w[i] * parts[i, ..., 2:]
            den = den + w[i] * parts[i, ..., 1:2]
    else:
        num, den = part[..., 2:], part[..., 1:2]
    o = (num / den).to(V.dtype)                                   # (B, G, rep, 1, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, G * rep, hd)


def _attention_sharded(p, x, cfg, pos, window, cache, cache_pos, causal, kv_override,
                       rules):
    """`attention` on this rank's shards (see `attn_mode`).  The residual
    `x` (B, Sq, D) is this rank's batch rows, replicated over `model`; the
    output is too."""
    mesh = rules.mesh
    B, Sq, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = nh // nkv
    decode = cache is not None and Sq == 1
    mode = attn_mode(cfg, rules, Sq, decode, kv_override is not None)
    sp = rules.leaf

    if mode == "heads":
        xf = C.enter(x, mesh, "model")
        h0, nh_loc = _model_split(rules, nh)
        q = torch.einsum("bsd,dhk->bshk", xf, weight(rules, p["wq"], sp("wq"), keep_model=True))
        if kv_override is not None:
            k, v = kv_override
        else:
            k = torch.einsum("bsd,dhk->bshk", xf, weight(rules, p["wk"], sp("wk")))
            v = torch.einsum("bsd,dhk->bshk", xf, weight(rules, p["wv"], sp("wv")))
            q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
            k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope)
        if cache is not None:
            _write_cache_sharded(rules, cache, k, v, Sq, window, cache_pos)
        o = ops.attention(q, _kv_heads_of(k, h0, nh_loc, rep), _kv_heads_of(v, h0, nh_loc, rep),
                          causal=causal and kv_override is None, window=window)
        wo = weight(rules, p["wo"], sp("wo"), keep_model=True)
        return C.all_reduce(torch.einsum("bqhd,hdm->bqm", o, wo), mesh, "model"), cache

    if mode == "seq":
        # the reference's _seq_parallel_attn: queries of this rank's slice,
        # K/V all-gathered over the sequence, kernel 5 at the slice's offset
        n = Sq // _msize(rules)
        s0 = mesh.index("model") * n
        xl = C.take(x, mesh, "model", 1)
        pl = pos.narrow(pos.dim() - 1, s0, n)
        w = {nm: weight(rules, p[nm], sp(nm)) for nm in ("wq", "wk", "wv", "wo")}
        q = apply_rope(torch.einsum("bsd,dhk->bshk", xl, w["wq"]), pl, cfg.rope_theta, cfg.mrope)
        k = apply_rope(torch.einsum("bsd,dhk->bshk", xl, w["wk"]), pl, cfg.rope_theta, cfg.mrope)
        v = torch.einsum("bsd,dhk->bshk", xl, w["wv"])
        K = C.all_gather(k, mesh, "model", 1, bwd="sum")
        V = C.all_gather(v, mesh, "model", 1, bwd="sum")
        if cache is not None:
            _write_cache_sharded(rules, cache, K, V, Sq, window, cache_pos)
        o = ops.attention(q, K, V, causal=causal, window=window, q_pos0=s0)
        out = torch.einsum("bqhd,hdm->bqm", o, w["wo"])
        return C.all_gather(out, mesh, "model", 1, bwd="slice"), cache

    # decode and replicated: every rank computes every head
    w = {nm: weight(rules, p[nm], sp(nm), use="replicated") for nm in ("wq", "wk", "wv", "wo")}
    q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
    if kv_override is not None:
        o = ops.attention(q, *kv_override, causal=False)
        return torch.einsum("bqhd,hdm->bqm", o, w["wo"]), None
    k = apply_rope(torch.einsum("bsd,dhk->bshk", x, w["wk"]), pos, cfg.rope_theta, cfg.mrope)
    v = torch.einsum("bsd,dhk->bshk", x, w["wv"])
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope)
    if cache is not None:
        _write_cache_sharded(rules, cache, k, v, Sq, window, cache_pos)
    if decode:
        o = _decode_attend(rules, q.reshape(B, 1, nkv, rep, hd), *cache, window, cache_pos)
    else:
        o = ops.attention(q, k, v, causal=causal, window=window)
    return torch.einsum("bqhd,hdm->bqm", o, w["wo"]), cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(key, d: int, f: int, gated: bool, dtype, device, draw=_init) -> Params:
    ks = prng.split(key, 3).unbind(-2)
    p = {"wi": draw(ks[0], (d, f), d ** -0.5, dtype, device)}
    if gated:
        p["wg"] = draw(ks[1], (d, f), d ** -0.5, dtype, device)
    p["wo"] = draw(ks[2], (f, d), f ** -0.5, dtype, device)
    return p


def mlp(p: Params, x: torch.Tensor, gated: bool = False, rules=None) -> torch.Tensor:
    """MLP block on (batch, seq, d) activations: ``(silu(x·wg) ⊙ x·wi)·wo``
    when gated (SwiGLU), else ``gelu(x·wi)·wo`` with the tanh approximation
    (the reference's `jax.nn.gelu` default).  With `rules` (scoped to the
    MLP's parameters): the hidden width over `model` where it divides, the
    `wo` product all-reduced."""
    tp = rules is not None and "model" in axes_of(rules.leaf("wi")[1])
    if rules is None:
        wi, wg, wo = p["wi"], p.get("wg"), p["wo"]
    else:
        use = "partial" if tp else "replicated"
        if tp:
            x = C.enter(x, rules.mesh, "model")
        wi, wo = (weight(rules, p[n], rules.leaf(n), keep_model=tp, use=use) for n in ("wi", "wo"))
        wg = weight(rules, p["wg"], rules.leaf("wg"), keep_model=tp, use=use) if gated else None
    h = torch.einsum("bsd,df->bsf", x, wi)
    if gated:
        h = F.silu(torch.einsum("bsd,df->bsf", x, wg)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("bsf,fd->bsd", h, wo)
    return C.all_reduce(out, rules.mesh, "model") if tp else out


# --------------------------------------------------------------------------
# MoE (fine-grained, shared experts, top-k token choice with capacity)
# --------------------------------------------------------------------------
def init_moe(key, cfg: ModelConfig, dtype, device, draw=_init) -> Params:
    """The reference's `init_moe`: a float32 router whatever `dtype`,
    (E, d, fe) expert weights and the gated shared expert of width
    fe·n_shared."""
    mc, d = cfg.moe, cfg.d_model
    fe = mc.d_expert or cfg.d_ff
    ks = prng.split(key, 5).unbind(-2)
    p = {"router": draw(ks[0], (d, mc.n_experts), d ** -0.5, torch.float32, device),
         "wi": draw(ks[1], (mc.n_experts, d, fe), d ** -0.5, dtype, device),
         "wg": draw(ks[2], (mc.n_experts, d, fe), d ** -0.5, dtype, device),
         "wo": draw(ks[3], (mc.n_experts, fe, d), fe ** -0.5, dtype, device)}
    if mc.n_shared:
        p["shared"] = init_mlp(ks[4], d, fe * mc.n_shared, True, dtype, device, draw)
    return p


def moe_capacity(T: int, cfg: ModelConfig) -> int:
    """Slots an expert takes for T tokens: ``max(⌈T·K/E·cf⌉, K)`` in
    Python floats, as the reference computes it."""
    mc = cfg.moe
    return max(int(math.ceil(T * mc.top_k / mc.n_experts * mc.capacity_factor)), mc.top_k)


def moe_route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` of the router's probabilities (T, E): the k largest
    a row in descending order, equal values lower expert id first (a stable
    descending sort; `torch.topk` promises no order among ties).  Returns
    (values, expert ids)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


class _RowGather(torch.autograd.Function):
    """``cat([src, 0])[index]``: rows of ``src`` (N, D), the index N reading
    a zero row, with a backward in a fixed order and no index-accumulate.
    ``back`` (N, J) lists, for each source row, the output rows that read
    it (the number of output rows for an empty place); its gradient is
    their gradients summed left to right, each add one elementwise pass, so
    a CUDA run gives the same bits every time (autograd's backward of the
    gather is an index-add)."""

    @staticmethod
    def forward(ctx, src, index, back):
        ctx.save_for_backward(back)
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        parts = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])[back]   # (N, J, D)
        out = parts[:, 0]
        for j in range(1, back.shape[1]):
            out = out + parts[:, j]
        return out, None, None


def _dispatch(xt: torch.Tensor, gate_vals: torch.Tensor, expert_ids: torch.Tensor, wi, wg, wo,
              e0: int, cap: int) -> torch.Tensor:
    """The routed experts' output (T, D) of experts [e0, e0 + E_loc) (the
    leading dimension of wi, wg, wo): the (token, k) pairs sorted stably by
    expert id, each expert's first `cap` kept (a pair's place is the one
    the global path gives it), gathered, the gated MLPs as grouped
    products, and each token's kept outputs times their gates summed in
    increasing expert order; pairs of other experts add nothing."""
    T, D = xt.shape
    K = expert_ids.shape[1]
    El = wi.shape[0]
    dev = xt.device
    flat_e = expert_ids.reshape(-1)                                      # (T·K,), t·K + k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = torch.arange(T * K, device=dev) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = (pos_in_e < cap) & (sorted_e >= e0) & (sorted_e < e0 + El)
    # the (E_loc·cap) dispatch table of source tokens; an empty slot reads the
    # zero row T, as the reference's zero-initialised dispatch buffer
    slot = torch.where(keep, (sorted_e - e0) * cap + pos_in_e, El * cap)
    table = torch.full((El * cap + 1,), T, dtype=torch.long, device=dev)
    table[slot] = torch.where(keep, order // K, T)
    # each token's pairs in increasing expert order, the order in which the
    # reference's scatter-add meets them, and the slot each one fills
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot                                                # by pair t·K + k
    by_expert = torch.argsort(expert_ids, dim=-1)                        # (T, K)
    pair = torch.arange(T, device=dev)[:, None] * K + by_expert
    reads = slot_of[pair]                                                # (T, K), E_loc·cap: none
    # slot → the (t, j) place that reads it (T·K: none); only the dropped
    # pairs share a target, the row past the slots, which is cut off
    reader = torch.full((El * cap + 1,), T * K, dtype=torch.long, device=dev)
    reader[reads.reshape(-1)] = torch.arange(T * K, device=dev)
    xe = _RowGather.apply(xt, table[:-1], reads).reshape(El, cap, D)

    h = torch.bmm(xe, wi)
    h = F.silu(torch.bmm(xe, wg)) * h
    ye = torch.bmm(h, wo).reshape(El * cap, D)

    # kept outputs times their gates, summed in that order
    contrib = _RowGather.apply(ye, reads.reshape(-1), reader[:-1, None]).reshape(T, K, D)
    contrib = contrib * torch.gather(gate_vals, 1, by_expert).to(xt.dtype)[:, :, None]
    out = contrib[:, 0]
    for j in range(1, K):
        out = out + contrib[:, j]
    return out


def _router(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig) -> tuple:
    """(probs, renormalised gates, expert ids, aux) of tokens (T, D)."""
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    T = xt.shape[0]
    probs = torch.softmax(xt.float() @ router, dim=-1)                   # (T, E)
    gate_vals, expert_ids = moe_route(probs, K)                          # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    # each expert's count into a fixed (E,) tensor (`bincount`'s size would
    # depend on the ids, which fake tensors cannot read)
    ids = expert_ids.reshape(-1)
    ce = torch.zeros((E,), dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids)).float() / (T * K)
    aux = E * torch.sum(me * ce) * mc.router_aux_weight
    return probs, gate_vals, expert_ids, aux


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig, rules=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE (reference `layers.moe`, its global path):
    float32 softmax router, gates renormalised over the K chosen, the
    Switch load-balance loss ``E·Σ(me·ce)·w``; a stable sort of the (token,
    k) pairs by expert id, each expert's first `moe_capacity` pairs kept
    and the rest dropped (they add nothing); the experts' gated MLPs as
    grouped products over (E, capacity, d); each token's kept outputs,
    times their gates cast to the activation type, summed in increasing
    expert order (the order of the reference's scatter-add), with no
    atomics, so a CUDA run gives the same bits every time; the shared
    expert added last.  The backward keeps that discipline (`_RowGather`):
    a token's gradient sums its kept slots' in the same increasing expert
    order, and a slot's is the one (token, k) pair that reads it.  Returns
    (out, aux).

    With `rules` (scoped to the MoE's parameters): the expert-parallel path
    (`_moe_expert_parallel`) where the experts divide `model` and the
    global batch has at least 4096 tokens (the reference's gate,
    `layers.py:478-482`); otherwise the global path over the whole global
    batch, its tokens gathered over the batch axes, every rank routing
    them alike, and this rank's rows kept."""
    if rules is not None:
        E, m = cfg.moe.n_experts, _msize(rules)
        if E % m == 0 and x.shape[0] * _batch_shards(rules) * x.shape[1] >= 4096:
            return _moe_expert_parallel(p, x, cfg, rules)
        return _moe_global_sharded(p, x, cfg, rules)
    mc = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    _, gate_vals, expert_ids, aux = _router(xt, p["router"], cfg)
    out = _dispatch(xt, gate_vals, expert_ids, p["wi"], p["wg"], p["wo"], 0,
                    moe_capacity(B * S, cfg))
    if mc.n_shared:
        out = out + mlp(p["shared"], xt[None], True)[0]
    return out.reshape(B, S, D), aux


def _moe_expert_parallel(p, x, cfg: ModelConfig, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_moe_expert_parallel`: the residual is replicated
    over `model`, so each rank routes all of its data shard's tokens, with
    the capacity of the local token count, to its E/model experts; the
    partial outputs are summed over `model` (in rank order, which is the
    global path's increasing expert order); aux is the mean over the data
    axes of each shard's aux; the shared expert is a sharded `mlp`."""
    mesh = rules.mesh
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    _, gate_vals, expert_ids, aux = _router(xt, p["router"], cfg)
    data = data_axes(rules.mesh)
    aux = C.all_reduce(aux, mesh, data) / mesh.size(data)
    w = {n: weight(rules, p[n], rules.leaf(n), keep_model=True) for n in ("wi", "wg", "wo")}
    e0, _ = _model_split(rules, cfg.moe.n_experts)
    out = _dispatch(C.enter(xt, mesh, "model"), C.enter(gate_vals, mesh, "model"), expert_ids,
                    w["wi"], w["wg"], w["wo"], e0, moe_capacity(T, cfg))
    out = C.all_reduce(out, mesh, "model").reshape(B, S, D)
    if cfg.moe.n_shared:
        out = out + mlp(p["shared"], x, True, rules.at("shared"))
    return out, aux


def _moe_global_sharded(p, x, cfg: ModelConfig, rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global path under sharding rules: the batch's tokens gathered
    over the batch axes and routed alike on every rank (capacity of the
    global token count); each rank computes its experts' share when the
    experts divide `model` (the partial outputs summed over `model` in rank
    order, the global path's increasing expert order), else every expert;
    this rank's rows kept.  The aux loss is the global batch's; its
    gradient counts once over the data ranks."""
    mesh = rules.mesh
    B, S, D = x.shape
    baxes = axes_of(rules.amap["batch"])
    xt = C.all_gather(x.reshape(B * S, D), mesh, baxes, 0, bwd="sum")
    T = xt.shape[0]
    _, gate_vals, expert_ids, aux = _router(xt, p["router"], cfg)
    data = data_axes(rules.mesh)
    aux = C.scale_grad(aux, 1.0 / mesh.size(data))
    ep = "model" in axes_of(rules.leaf("wi")[0])
    w = {n: weight(rules, p[n], rules.leaf(n), keep_model=ep,
                   use="partial" if ep else "replicated") for n in ("wi", "wg", "wo")}
    if ep:
        xt, gate_vals = C.enter(xt, mesh, "model"), C.enter(gate_vals, mesh, "model")
    e0 = _model_split(rules, cfg.moe.n_experts)[0] if ep else 0
    out = _dispatch(xt, gate_vals, expert_ids, w["wi"], w["wg"], w["wo"], e0,
                    moe_capacity(T, cfg))
    if ep:
        out = C.all_reduce(out, mesh, "model")
    out = out.narrow(0, mesh.index(baxes) * B * S, B * S).reshape(B, S, D)
    if cfg.moe.n_shared:
        out = out + mlp(p["shared"], x, True, rules.at("shared"))
    return out, aux


# --------------------------------------------------------------------------
# Mamba2 (SSD)
# --------------------------------------------------------------------------
def init_mamba(key, cfg: ModelConfig, dtype, device, draw=_init) -> Params:
    sc = cfg.ssm
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    conv_dim = di + 2 * sc.d_state
    ks = prng.split(key, 5).unbind(-2)
    lead = tuple(key.shape[:-1])
    f32 = dict(dtype=torch.float32, device=device)
    # log as XLA computes it (torch.log differs by an ulp on some integers)
    a_log = xla_math.log(torch.arange(1, nh + 1, **f32)) if device.type != "meta" \
        else torch.empty(nh, **f32)
    return {
        "in_proj": draw(ks[0], (d, 2 * di + 2 * sc.d_state + nh), d ** -0.5, dtype, device),
        "conv_w": draw(ks[1], (sc.conv_width, conv_dim), 0.5, dtype, device),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D": torch.ones(lead + (nh,), **f32),
        "dt_bias": torch.zeros(lead + (nh,), **f32),
        "norm": init_rmsnorm(di, dtype, device, lead),
        "out_proj": draw(ks[4], (di, d), di ** -0.5, dtype, device),
    }


def mamba(p: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Dict[str, torch.Tensor]] = None, *, rules=None
          ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 block (reference `layers.mamba`): in-projection, causal
    depthwise conv, SiLU, the SSD (kernel 6 over a full sequence or a
    prefill, the one-step recurrence in decode), D skip, gated RMSNorm,
    out-projection.  cache = {"conv": (B, W−1, conv_dim), "ssm": (B, H, hd,
    N) float32}; returns (out, new cache) with new tensors for the cache.

    With `rules` (scoped to the block's parameters and cache): the SSM
    heads over `model` where they divide (`_mamba_sharded`), else every
    rank computes every head; the cache's new tensors are this rank's
    shards."""
    if rules is not None:
        if "model" in axes_of(rules.leaf("A_log")[0]):
            return _mamba_sharded(p, x, cfg, cache, rules)
        full = {n: weight(rules, p[n], rules.leaf(n), use="replicated")
                for n in ("in_proj", "conv_w", "A_log", "D", "dt_bias", "out_proj")}
        full["norm"] = p["norm"]
        out, new = mamba(full, x, cfg, None if cache is None else
                         {"conv": _conv_state_full(rules, cache["conv"]), "ssm": cache["ssm"]})
        if new is not None:
            new["conv"] = _conv_state_part(rules, new["conv"])
        return out, new
    sc = cfg.ssm
    B, S, _ = x.shape
    di, H, hd, N, W = cfg.d_inner, cfg.n_ssm_heads, sc.head_dim, sc.d_state, sc.conv_width

    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xraw, Bmat, Cmat, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xraw, Bmat, Cmat], dim=-1)
    conv_dim = conv_in.shape[-1]
    if cache is None:
        pad = torch.zeros((B, W - 1, conv_dim), dtype=conv_in.dtype, device=x.device)
        seq = torch.cat([pad, conv_in], dim=1)
    else:
        seq = torch.cat([cache["conv"].to(conv_in.dtype), conv_in], dim=1)
    new_conv_state = seq[:, -(W - 1):, :] if W > 1 else None

    # causal depthwise conv of width W, as the sum of shifted products
    conv = sum(seq[:, i:i + S, :] * p["conv_w"][i][None, None, :] for i in range(W))
    conv = F.silu(conv)
    xc, Bc, Cc = torch.split(conv, [di, N, N], dim=-1)
    xh = xc.reshape(B, S, H, hd)

    A = -torch.exp(p["A_log"])
    dt_s = F.softplus(_f32(dt) + p["dt_bias"][None, None, :])

    if cache is None or S > 1:
        chunk = min(sc.chunk, S)
        if S % chunk:
            raise ValueError(f"a sequence of {S} positions does not split into SSD chunks "
                             f"of {chunk} (reference layers.py:568)")
        y, s_final = ops.ssd(_f32(xh), dt_s, A, _f32(Bc), _f32(Cc), chunk=chunk)
    else:
        # single-token decode: s = exp(dt·A) s + dt B ⊗ x ; y = C·s
        s_prev = _f32(cache["ssm"])
        dec = torch.exp(dt_s[:, 0] * A[None, :])
        upd = torch.einsum("bh,bn,bhd->bhdn", dt_s[:, 0], _f32(Bc[:, 0]), _f32(xh[:, 0]))
        s_final = s_prev * dec[:, :, None, None] + upd
        y = torch.einsum("bn,bhdn->bhd", _f32(Cc[:, 0]), s_final)[:, None]

    y = y + _f32(xh) * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])

    new_cache = None
    if cache is not None:
        conv_state = new_conv_state if new_conv_state is not None else torch.zeros(
            (B, 1, conv_dim), dtype=x.dtype, device=x.device)
        new_cache = {"conv": conv_state.to(cache["conv"].dtype), "ssm": _f32(s_final)}
    return out, new_cache


def _conv_state_full(rules, conv: torch.Tensor) -> torch.Tensor:
    """The conv tail (B, W−1, conv_dim) from this rank's shard of the cache
    (its channels split evenly over `model` where they divide)."""
    spec = rules.cache["conv"]
    return C.gather_to(conv, rules.mesh, spec, dims=(2,))


def _conv_state_part(rules, conv: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a full conv tail, by the cache's spec."""
    axes = axes_of(rules.cache["conv"][2])
    if not axes:
        return conv
    n = conv.shape[2] // rules.mesh.size(axes)
    return conv.narrow(2, rules.mesh.index(axes) * n, n)


def _mamba_sharded(p, x, cfg: ModelConfig, cache, rules):
    """`mamba` with the SSM heads over `model`: this rank's heads [h0,
    h0 + H/model) and their channels of z, x and dt, with B and C (shared
    by every head) on every rank.  The in-projection and conv weights are
    stored split evenly over `model` by the spec table (their concatenated
    output dimension, not by component); they are gathered and this rank's
    columns taken.  The gated RMSNorm sums its squares over `model`; the
    out-projection's rows are this rank's channels, its product
    all-reduced.  The conv tail is stored split evenly too, gathered to
    read and cut to write."""
    mesh = rules.mesh
    sc = cfg.ssm
    B, S, _ = x.shape
    di, H, hd, N, W = cfg.d_inner, cfg.n_ssm_heads, sc.head_dim, sc.d_state, sc.conv_width
    h0, Hl = _model_split(rules, H)
    c0, dl = h0 * hd, Hl * hd
    dev = x.device
    own = torch.arange(c0, c0 + dl, device=dev)
    bc = torch.arange(2 * N, device=dev)
    cols = torch.cat([own, di + own, 2 * di + bc,
                      2 * di + 2 * N + torch.arange(h0, h0 + Hl, device=dev)])
    ccols = torch.cat([own, di + bc])

    w_in = weight(rules, p["in_proj"], rules.leaf("in_proj")).index_select(1, cols)
    zxbcdt = torch.einsum("bsd,de->bse", C.enter(x, mesh, "model"), w_in)
    z, xraw, Bmat, Cmat, dt = torch.split(zxbcdt, [dl, dl, N, N, Hl], dim=-1)
    conv_in = torch.cat([xraw, Bmat, Cmat], dim=-1)
    if cache is None:
        state = None
        seq = torch.cat([torch.zeros((B, W - 1, dl + 2 * N), dtype=conv_in.dtype, device=dev),
                         conv_in], dim=1)
    else:
        state = _conv_state_full(rules, cache["conv"])
        seq = torch.cat([state.index_select(2, ccols).to(conv_in.dtype), conv_in], dim=1)
    cw = weight(rules, p["conv_w"], rules.leaf("conv_w")).index_select(1, ccols)
    conv = F.silu(sum(seq[:, i:i + S, :] * cw[i][None, None, :] for i in range(W)))
    xc, Bc, Cc = torch.split(conv, [dl, N, N], dim=-1)
    xh = xc.reshape(B, S, Hl, hd)

    A = -torch.exp(p["A_log"])
    dt_s = F.softplus(_f32(dt) + p["dt_bias"][None, None, :])
    if cache is None or S > 1:
        chunk = min(sc.chunk, S)
        if S % chunk:
            raise ValueError(f"a sequence of {S} positions does not split into SSD chunks "
                             f"of {chunk} (reference layers.py:568)")
        y, s_final = ops.ssd(_f32(xh), dt_s, A, _f32(Bc), _f32(Cc), chunk=chunk)
    else:
        s_prev = _f32(cache["ssm"])
        dec = torch.exp(dt_s[:, 0] * A[None, :])
        upd = torch.einsum("bh,bn,bhd->bhdn", dt_s[:, 0], _f32(Bc[:, 0]), _f32(xh[:, 0]))
        s_final = s_prev * dec[:, :, None, None] + upd
        y = torch.einsum("bn,bhdn->bhd", _f32(Cc[:, 0]), s_final)[:, None]

    y = y + _f32(xh) * p["D"][None, None, :, None]
    y = y.reshape(B, S, dl).to(x.dtype)
    g = _f32(y * F.silu(z))
    ss = C.all_reduce(torch.sum(g * g, dim=-1, keepdim=True), mesh, "model", bwd="sum")
    g = g * torch.rsqrt(ss / di + cfg.norm_eps)
    scale = weight(rules, p["norm"]["scale"], rules.at("norm").leaf("scale")).narrow(0, c0, dl)
    y = (g * _f32(scale)).to(x.dtype)
    w_out = weight(rules, p["out_proj"], rules.leaf("out_proj"), keep_model=True)
    out = C.all_reduce(torch.einsum("bsd,de->bse", y, w_out), mesh, "model")

    new_cache = None
    if cache is not None:
        with torch.no_grad():
            full_in = torch.cat([C.all_gather(xraw, mesh, "model", 2), Bmat, Cmat], dim=-1)
            tail = torch.cat([state.to(full_in.dtype), full_in], dim=1)[:, -(W - 1):, :]
        new_cache = {"conv": _conv_state_part(rules, tail).to(cache["conv"].dtype),
                     "ssm": _f32(s_final)}
    return out, new_cache
