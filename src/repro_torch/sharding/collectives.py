"""The LM's collectives over one run of mesh axes, on local shards, with
their conjugate backwards.

Each rank holds local tensors and the layers (`repro_torch.models.layers`)
call these where the reference's GSPMD program moves data:

* `all_gather` — the shards of a tensor along `dim`, concatenated in the
  axes' row-major order.  Backward ``"sum"`` (reduce-scatter: every rank's
  gradient of the gathered tensor summed, this rank's part kept) when each
  rank uses the gathered tensor in a computation of its own; ``"slice"``
  (this rank's part of the gradient) when the ranks use it alike.
* `all_reduce` — the sum (or max) over the axes.  Backward ``"identity"``
  when the ranks use the result alike, ``"sum"`` when each uses it in a
  computation of its own.
* `enter` — the identity, whose backward sums the gradient over the axes:
  a replicated tensor entering a computation that each rank does on its own
  part (Megatron's f).
* `take` — this rank's part of a replicated tensor along `dim`; backward
  all-gathers the parts.
* `reduce_scatter` — the sum over the axes, this rank's part kept.

A reduce-scatter splits the tensor along `dim` into n parts (n must
divide it), sends each rank its part of every rank's tensor in one
all-to-all, and sums the n parts it receives in rank order.  An all-reduce
is that reduce-scatter of the flattened tensor (padded to a multiple of
n), then an all-gather of the reduced slices.  Every element is the sum of
the ranks' values in rank order, the same float adds as a sum of the n
gathered operands, so every rank of a line gets the same bits, and a rerun
the same bits again (no reduction order is left to the backend).  gloo
moves CUDA tensors through pinned host buffers (ranks sharing one card);
NCCL moves them on the cards.  ``stats`` counts calls and bytes by kind,
forward and backward alike, until `reset_stats`: the bytes a rank receives
and holds.  That is n operands for an all-gather, |x| for a reduce-scatter
(n parts of |x|/n) and 2·|x| for an all-reduce (|x| of parts, then |x| of
reduced slices; x padded to a multiple of n elements).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_KINDS = ("all_gather", "all_reduce", "reduce_scatter")
#: one flat all-gather into a preallocated tensor (its newer name where
#: torch has it)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
#: calls and bytes by kind since the last `reset_stats`
stats = {k: {"calls": 0, "bytes": 0} for k in _KINDS}


def reset_stats() -> None:
    for k in _KINDS:
        stats[k] = {"calls": 0, "bytes": 0}


def snapshot() -> dict:
    return {k: dict(v) for k, v in stats.items()}


def _moved(mesh, axes, send: torch.Tensor, gather: bool) -> torch.Tensor:
    """One collective over `axes` of the flat contiguous `send`: an
    all-gather (``gather``: every rank's `send`, in row-major order) or an
    all-to-all of n equal parts (part i of the result: rank i's part for
    this rank).  gloo stages CUDA tensors through pinned host buffers."""
    n = mesh.size(axes)
    numel = send.numel() * (n if gather else 1)
    host = mesh.backend == "gloo" and send.is_cuda
    if host:
        src, out = _staging(send.dtype, send.numel(), numel)
        src.copy_(send)
    else:
        src, out = send, torch.empty((numel,), dtype=send.dtype, device=send.device)
    if gather:
        _ALL_GATHER(out, src, group=mesh.group(axes))
    else:
        dist.all_to_all_single(out, src, group=mesh.group(axes))
    return out.to(send.device) if host else out


def _stacked(mesh, axes, x: torch.Tensor, kind: str) -> torch.Tensor:
    """(n, *x.shape): every rank's `x` along `axes`, in row-major order,
    counted under `kind`."""
    n = mesh.size(axes)
    if n == 1:
        return x[None]
    stats[kind]["calls"] += 1
    stats[kind]["bytes"] += n * x.numel() * x.element_size()
    w = x.detach().contiguous()
    if w.dtype == torch.bool:
        w = w.view(torch.uint8)
    out = _moved(mesh, axes, w.reshape(-1), gather=True).view((n,) + tuple(x.shape))
    return out.view(torch.bool) if x.dtype == torch.bool else out


#: pinned host buffers that stage CUDA tensors for gloo, reused by size
_PINNED: dict = {}


def _staging(dtype, send: int, receive: int) -> tuple:
    """(send, receive) pinned host buffers of `send` and `receive`
    elements (grown as needed, kept for the next call: fresh pageable
    memory costs page faults at every call)."""
    have = _PINNED.get(dtype)
    if have is None or have.numel() < send + receive:
        have = _PINNED[dtype] = torch.empty((send + receive,), dtype=dtype, pin_memory=True)
    return have[:send], have[send:send + receive]


def _ordered_sum(g: torch.Tensor) -> torch.Tensor:
    out = g[0]
    for i in range(1, g.shape[0]):
        out = out + g[i]
    return out


def _gather(mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    g = _stacked(mesh, axes, x, "all_gather")
    return torch.cat(g.unbind(0), dim=dim) if g.shape[0] > 1 else x


def _part(mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * size, size)


def _scatter_sum(mesh, axes, w: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """This rank's slice of the reduction of (n·m, *rest) `w`: the ranks'
    slices exchanged in one all-to-all, then summed in rank order (or
    their max)."""
    n = mesh.size(axes)
    got = _moved(mesh, axes, w.detach().contiguous().reshape(-1), gather=False)
    got = got.view((n, w.shape[0] // n) + tuple(w.shape[1:]))
    return got.amax(dim=0) if op == "max" else _ordered_sum(got)


def _reduce_scatter(mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"a reduce-scatter over {n} ranks splits dimension {dim} of a "
                         f"{tuple(x.shape)} tensor into equal parts; it does not divide")
    stats["reduce_scatter"]["calls"] += 1
    stats["reduce_scatter"]["bytes"] += x.numel() * x.element_size()
    out = _scatter_sum(mesh, axes, x.movedim(dim, 0))
    return out.movedim(0, dim).contiguous()


def _reduce(mesh, axes, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    n = mesh.size(axes)
    if n == 1:
        return x
    flat = x.detach().reshape(-1)
    m = -(-flat.numel() // n)
    if m * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros((m * n - flat.numel(),))])
    stats["all_reduce"]["calls"] += 1
    stats["all_reduce"]["bytes"] += 2 * m * n * flat.element_size()
    mine = _scatter_sum(mesh, axes, flat, op)
    return _moved(mesh, axes, mine, gather=True)[:x.numel()].view(x.shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, bwd):
        ctx.mesh, ctx.axes, ctx.dim, ctx.bwd = mesh, axes, dim, bwd
        return _gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "sum":
            return _reduce_scatter(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None, None
        return _part(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, bwd):
        ctx.mesh, ctx.axes, ctx.bwd = mesh, axes, bwd
        return _reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "sum":
            return _reduce(ctx.mesh, ctx.axes, g), None, None, None
        return g, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(ctx.mesh, ctx.axes, g), None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _part(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, ctx.axes, g.contiguous(), ctx.dim), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _trivial(mesh, axes) -> bool:
    return mesh is None or mesh.size(axes) == 1


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0, bwd: str = "sum") -> torch.Tensor:
    """The shards of `x` along `dim` over `axes` (row-major order)."""
    if _trivial(mesh, axes):
        return x
    return _AllGather.apply(x, mesh, axes, dim % x.dim(), bwd)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum",
               bwd: str = "identity") -> torch.Tensor:
    """The sum (``op="sum"``) or max (``"max"``, no gradient) over `axes`."""
    if _trivial(mesh, axes):
        return x
    if op == "max":
        return _reduce(mesh, axes, x.detach(), "max")
    return _AllReduce.apply(x, mesh, axes, bwd)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The sum over `axes`, this rank's part along `dim` (no gradient)."""
    if _trivial(mesh, axes):
        return x
    return _reduce_scatter(mesh, axes, x.detach(), dim % x.dim())


def enter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity; the backward sums the gradient over `axes`."""
    if _trivial(mesh, axes):
        return x
    return _Enter.apply(x, mesh, axes)


def take(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's part of `x` along `dim`; the backward all-gathers."""
    if _trivial(mesh, axes):
        return x
    return _Take.apply(x, mesh, axes, dim % x.dim())


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity whose backward multiplies the gradient by `s`."""
    return x if s == 1 else _ScaleGrad.apply(x, s)


def gather_to(x: torch.Tensor, mesh, spec, dims: Optional[tuple] = None) -> torch.Tensor:
    """The global tensor from a local shard laid out by `spec` (no
    gradient): every sharded dimension (or those in `dims`) all-gathered."""
    from .rules import axes_of
    out = x.detach()
    for d, entry in enumerate(spec):
        if entry is not None and (dims is None or d in dims):
            out = _gather(mesh, axes_of(entry), out.contiguous(), d) \
                if mesh.size(axes_of(entry)) > 1 else out
    return out
