"""Train / prefill / decode step factories — port of `repro.models.steps`.

Each factory closes over the config and the sharding rules (None: one
device) and returns a plain function.  With rules, every rank runs the
step on its shards (`repro_torch.models.model`): the cross entropy is
vocab-parallel, the loss is the mean over the global batch's tokens, the
gradients of leaves replicated over the data axes are all-reduced there
(FSDP leaves are reduce-scattered by their gathers' backward) and AdamW
updates each rank's shards.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import device as _device
from ..core.pytree import tree_leaves, tree_map, tree_unflatten
from ..optim import adamw_update
from ..sharding import collectives as C
from ..sharding.rules import axes_of, data_axes, map_with_path
from . import layers as L
from . import model as M
from .config import ModelConfig


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of (B, S, V) logits against (B, S)
    labels, in float32 (reference `steps._xent`; the label's log-probability
    is read with a gather where the reference takes a masked sum over the
    vocabulary to keep a sharded vocabulary local — the same number, one
    term being nonzero)."""
    lg = L._f32(logits)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def _replicas(rules) -> int:
    """How many data ranks hold each batch row (batch axes narrower than
    the data axes)."""
    mesh = rules.mesh
    return mesh.size(data_axes(rules.mesh)) // mesh.size(axes_of(rules.amap["batch"]))


def make_fused_vocab_xent(cfg: ModelConfig, rules=None):
    """``xent(h, W, labels)``: the mean cross entropy of the logits h·W
    (float32, padded vocabulary slots at −1e30) against `labels`, whose
    backward recomputes the logits instead of storing them (reference
    `steps.make_fused_vocab_xent`, a custom_vjp).  The backward forms
    dlogits = (softmax − onehot)·g/n in float32, casts it to h's type, and
    takes dh = dlogits·Wᵀ and dW = hᵀ·dlogits.

    With `rules` (bound to the config) it is vocab-parallel: W is this
    rank's vocabulary slice (`model.vocab_slice`), the max and the sum of
    exponentials are all-reduced over `model`, the label's logit comes from
    the rank that holds it, dlogits stay in the slice and dh is all-reduced.
    h and labels are this rank's batch rows; the value is this rank's share
    of the mean over the global batch's tokens (the data ranks' shares sum
    to it; `replicas` ranks holding the same rows share it)."""
    if rules is not None:
        return _vocab_parallel_xent(cfg, rules)
    V, Vp = cfg.vocab_size, cfg.padded_vocab

    def _logits(h, W):
        lg = L._f32(torch.einsum("bsd,dv->bsv", h, W))
        if Vp != V:
            pad = torch.arange(Vp, device=h.device) >= V
            lg = lg + torch.where(pad, -1e30, 0.0).to(lg.dtype)
        return lg

    class FusedVocabXent(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, W, labels):
            ctx.save_for_backward(h, W, labels)
            return _xent(_logits(h, W), labels)

        @staticmethod
        def backward(ctx, g):
            h, W, labels = ctx.saved_tensors
            dlg = torch.softmax(_logits(h, W), dim=-1)    # recomputed
            n = h.shape[0] * h.shape[1]
            dlg.scatter_add_(-1, labels[..., None].long(),
                             torch.full(labels.shape + (1,), -1.0, dtype=dlg.dtype,
                                        device=dlg.device))
            dlg = dlg.mul_(g / n).to(h.dtype)
            dh = torch.einsum("bsv,dv->bsd", dlg, W)
            dW = torch.einsum("bsd,bsv->dv", h, dlg).to(W.dtype)
            return dh, dW, None

    return FusedVocabXent.apply


def _vocab_parallel_xent(cfg: ModelConfig, rules):
    mesh = rules.mesh
    V = cfg.vocab_size

    def _logits(h, W):
        v0, nv = M.vocab_slice(cfg, rules)
        lg = L._f32(torch.einsum("bsd,dv->bsv", h, W))
        if cfg.padded_vocab != V:
            pad = torch.arange(v0, v0 + nv, device=h.device) >= V
            lg = lg + torch.where(pad, -1e30, 0.0).to(lg.dtype)
        return lg, v0, nv

    # a vocabulary that does not divide `model` is whole on every rank
    axes = "model" if M.vocab_slice(cfg, rules)[1] != cfg.padded_vocab else ()

    def _stats(lg, labels, v0, nv):
        m = C.all_reduce(lg.amax(dim=-1), mesh, axes, op="max")
        se = C.all_reduce(torch.exp(lg - m[..., None]).sum(dim=-1), mesh, axes)
        mine = (labels >= v0) & (labels < v0 + nv)
        idx = torch.where(mine, labels - v0, 0).long()
        ll = torch.where(mine, torch.gather(lg, -1, idx[..., None])[..., 0], 0.0)
        return m, se, C.all_reduce(ll, mesh, axes), mine, idx

    class VocabParallelXent(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, W, labels):
            ctx.save_for_backward(h, W, labels)
            lg, v0, nv = _logits(h, W)
            m, se, ll, _, _ = _stats(lg, labels, v0, nv)
            n = h.shape[0] * h.shape[1] * rules.mesh.size(axes_of(rules.amap["batch"]))
            return torch.sum(m + torch.log(se) - ll) / n / _replicas(rules)

        @staticmethod
        def backward(ctx, g):
            h, W, labels = ctx.saved_tensors
            lg, v0, nv = _logits(h, W)                     # recomputed
            m, se, _, mine, idx = _stats(lg, labels, v0, nv)
            dlg = torch.exp(lg - m[..., None]) / se[..., None]
            dlg.scatter_add_(-1, idx[..., None],
                             torch.where(mine, -1.0, 0.0)[..., None].to(dlg.dtype))
            n = h.shape[0] * h.shape[1] * rules.mesh.size(axes_of(rules.amap["batch"]))
            dlg = dlg.mul_(g / n / _replicas(rules)).to(h.dtype)
            dh = C.all_reduce(torch.einsum("bsv,dv->bsd", dlg, W), mesh, axes)
            dW = torch.einsum("bsd,bsv->dv", h, dlg).to(W.dtype)
            return dh, dW, None

    return VocabParallelXent.apply


def make_grad_fn(cfg: ModelConfig, remat: bool = True, rules=None):
    """``grad_fn(params, batch) -> (loss, aux, grads)``: the reference's
    train loss (next-token fused cross entropy of the final hidden states,
    plus the MoE aux loss, zero for dense configs) and its gradient with
    respect to every parameter, a tree like `params` in their types.

    With `rules`: `params` and `batch` are this rank's shards, the loss is
    the global batch's (every rank returns it) and the gradients are this
    rank's shards of the global gradient: summed over the data axes for
    leaves replicated there, reduce-scattered (in the backward of their
    gathers) for FSDP leaves."""
    if rules is not None and rules.table is None:
        rules = rules.bind(cfg)
    xent = make_fused_vocab_xent(cfg, rules)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        h, _, aux = M.forward(params, cfg, inp, prefix_embeds=batch.get("prefix_embeds"),
                              frames=batch.get("frames"), remat=remat, return_hidden=True,
                              rules=rules)
        if cfg.n_prefix_embeds:
            h = h[:, cfg.n_prefix_embeds:, :]
        W = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        ce = xent(h, W, labels)
        return ce + aux, ce, aux

    def grad_fn(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, ce, aux = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        grads = tree_unflatten(params, grads)
        if rules is None:
            return loss.detach(), aux.detach(), grads
        data = data_axes(rules.mesh)
        grads = _sum_over_data(grads, rules)
        loss = C.all_reduce(ce.detach(), rules.mesh, data) + aux.detach()
        return loss, aux.detach(), grads

    return grad_fn


def _sum_over_data(grads, rules):
    """Gradients of leaves that no data axis shards summed over the data
    axes (in rank order); FSDP leaves' are already reduce-scattered.  The
    specs come from the bound rules' table (no parameter shapes are drawn
    here, so the step also runs on fake tensors)."""
    data = data_axes(rules.mesh)

    def f(path, g):
        if any(a in data for e in rules.table[path] for a in axes_of(e)):
            return g
        return C.all_reduce(g, rules.mesh, data)
    return map_with_path(f, grads)


def make_train_step(cfg: ModelConfig, rules=None, lr: float = 3e-4, remat: bool = True,
                    microbatch: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "aux"})``: the loss's gradient (`make_grad_fn`) and one AdamW
    step (reference `steps.make_train_step`).  ``microbatch > 1`` splits the
    batch's rows into that many slices and sums their gradients in a float32
    accumulator, in order, before dividing and casting to each parameter's
    type.  The parameters and the optimizer state are updated in place and
    returned (the reference's jit is donated them).  With `rules` every
    rank steps its shards (`make_grad_fn`)."""
    grad_fn = make_grad_fn(cfg, remat, rules)

    def train_step(params, opt_state, batch):
        if microbatch == 1:
            loss, aux, grads = grad_fn(params, batch)
        else:
            loss = aux = torch.zeros((), dtype=torch.float32,
                                     device=batch["tokens"].device)
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            for i in range(microbatch):
                mb = {k: v[i * (v.shape[0] // microbatch):(i + 1) * (v.shape[0] // microbatch)]
                      for k, v in batch.items()}
                l_i, a_i, g_i = grad_fn(params, mb)
                loss, aux = loss + l_i, aux + a_i
                gsum = tree_map(lambda s, g: s + g.to(torch.float32), gsum, g_i)
                del g_i
            loss, aux = loss / microbatch, aux / microbatch
            grads = tree_map(lambda s, p: (s / microbatch).to(p.dtype), gsum, params)
            del gsum
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": loss, "aux": aux}

    return train_step


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


def make_prefill_step(cfg: ModelConfig, rules=None):
    """``prefill_step(params, batch, cache) -> (last-position logits,
    cache)``, positions 0 .. S−1.  With `rules`, this rank's rows over its
    vocabulary slice (`model.gather_logits` gathers the vocabulary)."""
    if rules is not None and rules.table is None:
        rules = rules.bind(cfg)

    def prefill_step(params, batch, cache):
        logits, cache, _ = M.forward(params, cfg, batch["tokens"], cache=cache, cache_pos=0,
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     frames=batch.get("frames"), rules=rules)
        return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, rules=None, *, return_logits: bool = False):
    """One decode step, ``serve_step(params, batch, cache, pos) ->
    (next_tok, cache)``: next-token logits at position `pos`, greedy
    argmax as int32, the cache updated.  With ``return_logits`` the step
    also returns the (B, 1, V) logits.  With `rules` the argmax is over the
    gathered vocabulary and the logits returned are the gathered ones."""
    if rules is not None and rules.table is None:
        rules = rules.bind(cfg)

    def serve_step(params, batch, cache, pos):
        logits, cache, _ = M.forward(params, cfg, batch["tokens"], cache=cache,
                                     cache_pos=pos, frames=batch.get("frames"), rules=rules)
        logits = M.gather_logits(logits, cfg, rules)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return (next_tok, cache, logits) if return_logits else (next_tok, cache)

    return serve_step
