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
6's dA).  The MoE is the reference's single-device global path
(`layers.moe` without sharding rules); its expert-parallel dispatch comes
with LM sharding (ROADMAP.md §1 item 18.7).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import prng, xla_math
from ..kernels import ops
from ..kernels.threefry_normal import threefry_normal
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
    float32 copy of a whole leaf is held."""
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
# Norm
# --------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device, lead: tuple = ()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS normalisation in float32, cast back to the input type."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


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
        comp = torch.repeat_interleave(torch.arange(3, device=pos.device),
                                       torch.tensor(mrope_sections(hd), device=pos.device))
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
def init_attention(key, cfg: ModelConfig, dtype, device) -> Params:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ks = prng.split(key, 4).unbind(-2)
    s = d ** -0.5
    return {
        "wq": _init(ks[0], (d, nh, hd), s, dtype, device),
        "wk": _init(ks[1], (d, nkv, hd), s, dtype, device),
        "wv": _init(ks[2], (d, nkv, hd), s, dtype, device),
        "wo": _init(ks[3], (nh, hd, d), (nh * hd) ** -0.5, dtype, device),
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
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[tuple]]:
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
    stripe, so the pair has no one function, and it raises here."""
    if window is not None and not causal:
        raise ValueError("a sliding window applies to causal attention only")
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


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(key, d: int, f: int, gated: bool, dtype, device) -> Params:
    ks = prng.split(key, 3).unbind(-2)
    p = {"wi": _init(ks[0], (d, f), d ** -0.5, dtype, device)}
    if gated:
        p["wg"] = _init(ks[1], (d, f), d ** -0.5, dtype, device)
    p["wo"] = _init(ks[2], (f, d), f ** -0.5, dtype, device)
    return p


def mlp(p: Params, x: torch.Tensor, gated: bool = False) -> torch.Tensor:
    """MLP block on (batch, seq, d) activations: ``(silu(x·wg) ⊙ x·wi)·wo``
    when gated (SwiGLU), else ``gelu(x·wi)·wo`` with the tanh approximation
    (the reference's `jax.nn.gelu` default)."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if gated:
        h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# --------------------------------------------------------------------------
# MoE (fine-grained, shared experts, top-k token choice with capacity)
# --------------------------------------------------------------------------
def init_moe(key, cfg: ModelConfig, dtype, device) -> Params:
    """The reference's `init_moe`: a float32 router whatever `dtype`,
    (E, d, fe) expert weights and the gated shared expert of width
    fe·n_shared."""
    mc, d = cfg.moe, cfg.d_model
    fe = mc.d_expert or cfg.d_ff
    ks = prng.split(key, 5).unbind(-2)
    p = {"router": _init(ks[0], (d, mc.n_experts), d ** -0.5, torch.float32, device),
         "wi": _init(ks[1], (mc.n_experts, d, fe), d ** -0.5, dtype, device),
         "wg": _init(ks[2], (mc.n_experts, d, fe), d ** -0.5, dtype, device),
         "wo": _init(ks[3], (mc.n_experts, fe, d), fe ** -0.5, dtype, device)}
    if mc.n_shared:
        p["shared"] = init_mlp(ks[4], d, fe * mc.n_shared, True, dtype, device)
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


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
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
    (out, aux)."""
    mc = cfg.moe
    B, S, D = x.shape
    E, K = mc.n_experts, mc.top_k
    T = B * S
    xt = x.reshape(T, D)

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)              # (T, E)
    gate_vals, expert_ids = moe_route(probs, K)                          # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(0)
    ce = torch.bincount(expert_ids.reshape(-1), minlength=E).float() / (T * K)
    aux = E * torch.sum(me * ce) * mc.router_aux_weight

    cap = moe_capacity(T, cfg)
    flat_e = expert_ids.reshape(-1)                                      # (T·K,), t·K + k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = torch.arange(T * K, device=x.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos_in_e < cap
    # the (E·cap) dispatch table of source tokens; an empty slot reads the
    # zero row T, as the reference's zero-initialised dispatch buffer
    slot = torch.where(keep, sorted_e * cap + pos_in_e, E * cap)
    table = torch.full((E * cap + 1,), T, dtype=torch.long, device=x.device)
    table[slot] = torch.where(keep, order // K, T)
    # each token's pairs in increasing expert order, the order in which the
    # reference's scatter-add meets them, and the slot each one fills
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot                                                # by pair t·K + k
    by_expert = torch.argsort(expert_ids, dim=-1)                        # (T, K)
    pair = torch.arange(T, device=x.device)[:, None] * K + by_expert
    reads = slot_of[pair]                                                # (T, K), E·cap: dropped
    # slot → the (t, j) place that reads it (T·K: none); only the dropped
    # pairs share a target, the row past the slots, which is cut off
    reader = torch.full((E * cap + 1,), T * K, dtype=torch.long, device=x.device)
    reader[reads.reshape(-1)] = torch.arange(T * K, device=x.device)
    xe = _RowGather.apply(xt, table[:-1], reads).reshape(E, cap, D)

    h = torch.bmm(xe, p["wi"])
    h = F.silu(torch.bmm(xe, p["wg"])) * h
    ye = torch.bmm(h, p["wo"]).reshape(E * cap, D)

    # kept outputs times their gates, summed in that order
    contrib = _RowGather.apply(ye, reads.reshape(-1), reader[:-1, None]).reshape(T, K, D)
    contrib = contrib * torch.gather(gate_vals, 1, by_expert).to(x.dtype)[:, :, None]
    out = contrib[:, 0]
    for j in range(1, K):
        out = out + contrib[:, j]

    if mc.n_shared:
        out = out + mlp(p["shared"], xt[None], True)[0]
    return out.reshape(B, S, D), aux


# --------------------------------------------------------------------------
# Mamba2 (SSD)
# --------------------------------------------------------------------------
def init_mamba(key, cfg: ModelConfig, dtype, device) -> Params:
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
        "in_proj": _init(ks[0], (d, 2 * di + 2 * sc.d_state + nh), d ** -0.5, dtype, device),
        "conv_w": _init(ks[1], (sc.conv_width, conv_dim), 0.5, dtype, device),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D": torch.ones(lead + (nh,), **f32),
        "dt_bias": torch.zeros(lead + (nh,), **f32),
        "norm": init_rmsnorm(di, dtype, device, lead),
        "out_proj": _init(ks[4], (di, d), di ** -0.5, dtype, device),
    }


def mamba(p: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Dict[str, torch.Tensor]] = None
          ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 block (reference `layers.mamba`): in-projection, causal
    depthwise conv, SiLU, the SSD (kernel 6 over a full sequence or a
    prefill, the one-step recurrence in decode), D skip, gated RMSNorm,
    out-projection.  cache = {"conv": (B, W−1, conv_dim), "ssm": (B, H, hd,
    N) float32}; returns (out, new cache) with new tensors for the cache."""
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
    dt_s = F.softplus(dt.float() + p["dt_bias"][None, None, :])

    if cache is None or S > 1:
        chunk = min(sc.chunk, S)
        if S % chunk:
            raise ValueError(f"a sequence of {S} positions does not split into SSD chunks "
                             f"of {chunk} (reference layers.py:568)")
        y, s_final = ops.ssd(xh.float(), dt_s, A, Bc.float(), Cc.float(), chunk=chunk)
    else:
        # single-token decode: s = exp(dt·A) s + dt B ⊗ x ; y = C·s
        s_prev = cache["ssm"].float()
        dec = torch.exp(dt_s[:, 0] * A[None, :])
        upd = torch.einsum("bh,bn,bhd->bhdn", dt_s[:, 0], Bc[:, 0].float(), xh[:, 0].float())
        s_final = s_prev * dec[:, :, None, None] + upd
        y = torch.einsum("bn,bhdn->bhd", Cc[:, 0].float(), s_final)[:, None]

    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])

    new_cache = None
    if cache is not None:
        conv_state = new_conv_state if new_conv_state is not None else torch.zeros(
            (B, 1, conv_dim), dtype=x.dtype, device=x.device)
        new_cache = {"conv": conv_state.to(cache["conv"].dtype), "ssm": s_final.float()}
    return out, new_cache
