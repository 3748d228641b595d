"""Train / prefill / decode step factories — port of `repro.models.steps`.

Each factory closes over the config and returns a plain function.  The
reference's factories also take sharding rules; the port runs the LM on
one device and has none (LM sharding is ROADMAP.md §1 item 18.7).
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import device as _device
from ..core.pytree import tree_leaves, tree_map, tree_unflatten
from ..optim import adamw_update
from . import model as M
from .config import ModelConfig


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of (B, S, V) logits against (B, S)
    labels, in float32 (reference `steps._xent`; the label's log-probability
    is read with a gather where the reference takes a masked sum over the
    vocabulary to keep a sharded vocabulary local — the same number, one
    term being nonzero)."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def make_fused_vocab_xent(cfg: ModelConfig):
    """``xent(h, W, labels)``: the mean cross entropy of the logits h·W
    (float32, padded vocabulary slots at −1e30) against `labels`, whose
    backward recomputes the logits instead of storing them (reference
    `steps.make_fused_vocab_xent`, a custom_vjp).  The backward forms
    dlogits = (softmax − onehot)·g/n in float32, casts it to h's type, and
    takes dh = dlogits·Wᵀ and dW = hᵀ·dlogits."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab

    def _logits(h, W):
        lg = torch.einsum("bsd,dv->bsv", h, W).to(torch.float32)
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


def make_grad_fn(cfg: ModelConfig, remat: bool = True):
    """``grad_fn(params, batch) -> (loss, aux, grads)``: the reference's
    train loss (next-token fused cross entropy of the final hidden states,
    plus the MoE aux loss, zero for dense configs) and its gradient with
    respect to every parameter, a tree like `params` in their types."""
    xent = make_fused_vocab_xent(cfg)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        h, _, aux = M.forward(params, cfg, inp, prefix_embeds=batch.get("prefix_embeds"),
                              frames=batch.get("frames"), remat=remat, return_hidden=True)
        if cfg.n_prefix_embeds:
            h = h[:, cfg.n_prefix_embeds:, :]
        W = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return xent(h, W, labels) + aux, aux

    def grad_fn(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        return loss.detach(), aux.detach(), tree_unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, remat: bool = True,
                    microbatch: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "aux"})``: the loss's gradient (`make_grad_fn`) and one AdamW
    step (reference `steps.make_train_step`).  ``microbatch > 1`` splits the
    batch's rows into that many slices and sums their gradients in a float32
    accumulator, in order, before dividing and casting to each parameter's
    type.  The parameters and the optimizer state are updated in place and
    returned (the reference's jit is donated them)."""
    grad_fn = make_grad_fn(cfg, remat)

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
