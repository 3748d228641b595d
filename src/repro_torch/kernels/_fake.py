"""Fake-tensor routes of the kernels on the LM path: 5, 5b, 6 and 6b.

The dry run (`repro_torch.launch.dryrun`) runs a step on fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`): shapes and types, no
storage, no launch.  A kernel wrapper given fake tensors, of either
device, takes its CUDA path and calls one of the custom operators here in
place of its ctypes launch.  Each operator
allocates what the CUDA path allocates, at its shapes and types: the
outputs and the workspace (kernel 5b's row statistics and, in bfloat16
with grouped heads, its float32 partial sums of dk and dv, freed on return;
kernel 6's chunk states, kept for 6b; 6b's own, freed on return), so the
dry run's memory is the card path's and not the plain versions'.  Each
has a flop formula for `torch.utils.flop_counter.FlopCounterMode` that
counts what the counter counts for the plain version at the same shapes
(its einsums as batched products, 2·m·n·k each; elementwise work is not
counted), so a fake step's flops equal the CPU route's.

The operators are defined when this module is imported (before any
`FlopCounterMode` that should count them is made: a counter copies the
formulas it knows when it is made).  Their real implementations raise:
a real tensor never takes these routes (a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version).
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: kernel 5b's workspace rows are padded to a multiple of this
#: (``csrc/flash_attention_bwd.cu``, ``tc::kPad``)
ATTN_BWD_PAD = 128
#: kernel 6's chunk (``csrc/ssd_scan.cu``, ``kL``)
SSD_KERNEL_CHUNK = 128


def is_fake(t: torch.Tensor) -> bool:
    """True for a fake tensor (`FakeTensorMode`); a class check, so a real
    call pays a few tens of nanoseconds for it."""
    return isinstance(t, FakeTensor)


def attention_flops(B: int, Sq: int, Sk: int, H: int, hd: int, backward: bool = False) -> int:
    """The plain attention's counted flops: two (Sq × hd)·(hd × Sk)-sized
    products a query head forward, and the two products of each one's
    gradient backward (q, k and v all taking gradients, as on the LM's
    path)."""
    fwd = 4 * B * H * Sq * Sk * hd
    return 2 * fwd if backward else fwd


def ssd_flops(Bsz: int, S: int, H: int, hd: int, N: int, chunk: int,
              backward: bool = False, dstate: bool = True) -> int:
    """The plain SSD's counted flops at chunks of
    `ssd_scan.plain_chunk(S, chunk)`:
    C·Bᵀ (c·N a position), the intra-chunk outputs (H·c·hd), the chunk
    states and the inter-chunk outputs (H·hd·N each), 2 a multiply-add.
    Backward, as autograd prunes it: both operand gradients of C·Bᵀ and
    of the intra-chunk outputs; of the chunk states only when a gradient
    reaches them (from the final state, `dstate`, or from a later chunk);
    of the inter-chunk outputs C's, and the entry states' only past the
    first chunk (the first enters at zero)."""
    from .ssd_scan import plain_chunk

    c = plain_chunk(S, chunk)
    cb, intra = 2 * Bsz * S * c * N, 2 * Bsz * S * H * c * hd
    states = inter = 2 * Bsz * S * H * hd * N
    if not backward:
        return cb + intra + states + inter
    carried = S > c
    return (2 * cb + 2 * intra + (2 * states if carried or dstate else 0)
            + (2 * inter if carried else inter))


def attention_bwd_workspace_floats(B: int, Sq: int, H: int) -> int:
    """``flash_attention_bwd_workspace_floats``: three float32 rows of Sq
    padded to `ATTN_BWD_PAD`, a (batch, head)."""
    return 3 * B * H * (-(-Sq // ATTN_BWD_PAD) * ATTN_BWD_PAD)


def attention_bwd_partial_floats(bf16: bool, B: int, Sk: int, H: int, KVH: int, hd: int) -> int:
    """``flash_attention_bwd_partial_floats``: float32 partial sums of dv and
    dk over a KV head's query heads, in bfloat16 with grouped heads."""
    return 2 * B * Sk * KVH * hd if bf16 and H > KVH else 0


def ssd_workspace_floats(Bsz: int, S: int, H: int, hd: int, N: int) -> int:
    """``ssd_scan_workspace_floats``: the chunks' cumulative decays (kL a
    head), decays, C·Bᵀ (kL × kL) and chunk states (hd × N a head), each
    section rounded up to 4 floats."""
    def up4(n):
        return (n + 3) // 4 * 4
    kL = SSD_KERNEL_CHUNK
    bc = Bsz * (-(-S // kL))
    return up4(bc * H * kL) + up4(bc * H) + up4(bc * kL * kL) + up4(bc * H * hd * N)


def ssd_bwd_workspace_floats(Bsz: int, S: int, H: int, hd: int, N: int) -> int:
    """``ssd_scan_bwd_workspace_floats``: the chunks' state gradients
    (rounded up to 8 bytes), then in double each chunk's share of dA and
    its cumulative decays, then its decays."""
    kL = SSD_KERNEL_CHUNK
    bc = Bsz * (-(-S // kL))
    return (bc * H * hd * N + 1) // 2 * 2 + 2 * bc * H * (1 + kL) + bc * H


_REAL = ("the {} operator is the fake-tensor route of its kernel; a real tensor "
         "launches the kernel or takes its plain version")


@functools.lru_cache(maxsize=None)
def ops():
    """The four operators (``torch.ops.repro_torch``), defined and given
    their flop formulas once."""
    from torch.library import custom_op
    from torch.utils.flop_counter import register_flop_formula

    def real(name):
        def impl(*args):
            raise RuntimeError(_REAL.format(name))
        return impl

    attn = custom_op("repro_torch::flash_attention", real("flash_attention"), mutates_args=(),
                     schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
                            "int q_pos0) -> Tensor")

    @attn.register_fake
    def _(q, k, v, causal, window, q_pos0):
        return q.new_empty(q.shape)

    attn_bwd = custom_op(
        "repro_torch::flash_attention_bwd", real("flash_attention_bwd"), mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, Tensor dout, bool causal, int window, "
               "int q_pos0) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")

    @attn_bwd.register_fake
    def _(q, k, v, dout, causal, window, q_pos0):
        B, Sq, H, hd = q.shape
        Sk, KVH = k.shape[1], k.shape[2]
        part = attention_bwd_partial_floats(q.dtype == torch.bfloat16, B, Sk, H, KVH, hd)
        return (q.new_empty(q.shape), q.new_empty(k.shape), q.new_empty(k.shape),
                q.new_empty((attention_bwd_workspace_floats(B, Sq, H),), dtype=torch.float32),
                q.new_empty((part,), dtype=torch.float32))

    ssd = custom_op("repro_torch::ssd_scan", real("ssd_scan"), mutates_args=(),
                    schema="(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, int chunk) "
                           "-> (Tensor, Tensor, Tensor)")

    @ssd.register_fake
    def _(x, dt, A, B, C, chunk):
        Bsz, S, H, hd = x.shape
        N = B.shape[-1]
        f32 = dict(dtype=torch.float32)
        return (x.new_empty((Bsz, S, H, hd), **f32), x.new_empty((Bsz, H, hd, N), **f32),
                x.new_empty((ssd_workspace_floats(Bsz, S, H, hd, N),), **f32))

    ssd_bwd = custom_op(
        "repro_torch::ssd_scan_bwd", real("ssd_scan_bwd"), mutates_args=(),
        schema="(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor dy, "
               "Tensor? dstate, Tensor fws, int chunk) "
               "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")

    @ssd_bwd.register_fake
    def _(x, dt, A, B, C, dy, dstate, fws, chunk):
        Bsz, S, H, hd = x.shape
        N = B.shape[-1]
        f32 = dict(dtype=torch.float32)
        return (x.new_empty((Bsz, S, H, hd), **f32), x.new_empty((Bsz, S, H), **f32),
                x.new_empty((H,), **f32), x.new_empty((Bsz, S, N), **f32),
                x.new_empty((Bsz, S, N), **f32),
                x.new_empty((ssd_bwd_workspace_floats(Bsz, S, H, hd, N),), **f32))

    ns = torch.ops.repro_torch

    @register_flop_formula(ns.flash_attention)
    def _(q, k, v, *args, out_shape=None, **kwargs):
        return attention_flops(q[0], q[1], k[1], q[2], q[3])

    @register_flop_formula(ns.flash_attention_bwd)
    def _(q, k, v, dout, *args, out_shape=None, **kwargs):
        return attention_flops(q[0], q[1], k[1], q[2], q[3], backward=True)

    @register_flop_formula(ns.ssd_scan)
    def _(x, dt, A, B, C, chunk, *args, out_shape=None, **kwargs):
        return ssd_flops(*x, B[-1], chunk)

    @register_flop_formula(ns.ssd_scan_bwd)
    def _(x, dt, A, B, C, dy, dstate, fws, chunk, *args, out_shape=None, **kwargs):
        return ssd_flops(*x, B[-1], chunk, backward=True, dstate=dstate is not None)

    return ns


ops()
