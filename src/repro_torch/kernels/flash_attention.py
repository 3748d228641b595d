"""Exact masked softmax attention over grouped-query heads: the CUDA kernel
and its plain version.

Port of `repro.kernels.flash_attention` together with the head folding of
`repro.kernels.ops.attention`.  `flash_attention(q, k, v, causal=, window=)`
computes ``o = softmax(q·kᵀ/√hd + mask)·v`` for q (B, Sq, H, hd) and k, v
(B, Sk, KVH, hd), query head h reading KV head ``h // (H // KVH)``.  The
mask keeps key j for query row i, at position ``p = q_pos0 + i``, when
``j <= p`` (causal) and ``j > p - window`` (sliding window); masked scores
are −1e30, as in the reference, so a row that sees no key averages every
value.  ``q_pos0`` (default 0) is the position of the first query: a
sequence-parallel rank's slice of the queries against every key (the
reference's `_blocked_attn(..., q_pos0=)`); a causal call at an offset
needs ``Sk >= q_pos0 + Sq``.  Inputs are float32 or
bfloat16 (all three of one type); scores, softmax and the P·V sums are
float32 and the result has the input type.

`flash_attention` launches the hand-written kernels
(``csrc/flash_attention.cu``) on CUDA tensors, reading q, k and v in place,
and takes the plain PyTorch version, `flash_attention_plain`, only for
tensors on the CPU.  The kernel is chosen by type: bfloat16 runs on the
tensor cores (wgmma fed by TMA), which needs TMA's layout: unit head-dim
stride, every other stride a multiple of 8 elements, 16-byte aligned data
and a head size that is a multiple of 8 (`check_tma_layout`; anything else
raises `ValueError`, nothing is copied); float32 runs FMAs on the CUDA
cores through any strides.  The plain version is the reference's
`attention_ref` in the GQA layout: one float32 einsum for the scores, the
masked softmax, one einsum for P·V.

Gradients: when grad mode is on and an input requires one, a CUDA call goes
through `FlashAttention`, an autograd Function whose backward launches the
hand-written backward (``csrc/flash_attention_bwd.cu``: dq, dk and dv in
float32 sums, deterministic, two launches); the reference differentiates its
attention with jax.grad.  Its bfloat16 kernels run on the tensor cores as
the forward's does (wgmma fed by TMA, warp-specialised): a dq launch that
recomputes each row's softmax statistics, and a dk/dv launch in which one
consumer warpgroup owns dv and another dk, P passing between them through
shared memory.  P (into dv) and dS (into dq, dk) enter wgmma split into two
bfloat16 terms, since one bfloat16 rounding of either leaves the backward's
gate.  They take q, k and v in TMA's layout (as the forward) and a
contiguous dO (copied when it is not); float32 runs FMAs on the CUDA cores
through any strides.  A CPU call takes `flash_attention_plain`, which
autograd differentiates.  Without a gradient to take, a CUDA call launches
the forward kernel alone, as before.

Fake tensors (the dry run, `repro_torch.launch.dryrun`), CUDA or CPU,
take the CUDA path with the kernels' fake-tensor routes (`_fake`) where it
launches: the same outputs and workspace, the plain version's flop count,
no launch and no count.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _fake

#: launches of the CUDA kernel since the last reset (the plain version on
#: CPU tensors does not count)
launches = 0
#: calls of the CUDA backward since the last reset, one a call, and the CUDA
#: launches they made (two a call)
bwd_launches = 0
bwd_cuda_launches = 0

#: the largest head size the kernel takes
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the float32 kernel's grid puts the heads on its y axis and the batch on
#: its z axis; the bfloat16 kernel's the batch on y, 128-query blocks on z
_MAX_GRID_YZ = 65535
_BF16_QUERIES_A_BLOCK = 128
#: the kernels' templates by type: padded head sizes
TEMPLATES = {"float32": (32, 64, 128, 256), "bfloat16": (64, 128, 256)}
#: the backward's kernels by type: (dq launch, dk/dv launch)
BWD_KERNELS = {"float32": ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel"),
               "bfloat16": ("attn_bwd_dq_wgmma", "attn_bwd_dkdv_wgmma")}
_NEG = -1e30
_lib = None
#: the backward's C entry: q, k, v, dO, dq, dk, dv, workspace; type, B, Sq,
#: Sk, H, KVH, hd, causal, window, q_pos0; strides, stream, launches made
_BWD_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 10
             + (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)))


def _library():
    """The kernel library, with its entry points' signatures set once (a
    use of it for `_build.recording`, as `_build.bind` counts one)."""
    global _lib
    _build.note("flash_attention")
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                        + [ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_attributes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_attributes.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], plain: bool = False, causal: bool = False,
           q_pos0: int = 0) -> None:
    """Raise for what neither version takes; `plain` also admits float64
    (the plain version's float64 runs are the backward's yardstick)."""
    types = (*_DTYPES, torch.float64) if plain else tuple(_DTYPES)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"attention takes (batch, seq, heads, head_dim) tensors; "
                             f"{name} has shape {tuple(x.shape)}")
        if x.dtype not in types:
            raise TypeError(f"attention takes float32 or bfloat16; {name} is {x.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v differ in type: {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    KVH = k.shape[2]
    if KVH == 0 or H % KVH:
        raise ValueError(f"{H} query heads do not split into groups over {KVH} KV heads")
    if k.shape[1] == 0:
        raise ValueError("attention needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of positions, got {window}")
    if q_pos0 < 0:
        raise ValueError(f"q_pos0 must be a position, got {q_pos0}")
    if q_pos0 and causal and k.shape[1] < q_pos0 + Sq:
        raise ValueError(f"causal queries at positions {q_pos0} .. {q_pos0 + Sq - 1} need "
                         f"at least {q_pos0 + Sq} keys; got {k.shape[1]}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k and v lie on different devices {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cuda or cpu, got {q.device}")


def mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
         device=None, q_pos0: int = 0) -> torch.Tensor:
    """The (Sq, Sk) boolean mask of visible keys (reference
    `flash_attention.py:44-50`), query row i at position ``q_pos0 + i``."""
    qi = q_pos0 + torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (ki <= qi)
    if window is not None:
        keep = keep & (ki > qi - window)
    return keep


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          q_pos0: int = 0) -> torch.Tensor:
    """The exact masked softmax in float32 (float64 for float64 inputs), cast
    to the input type."""
    _check(q, k, v, window, plain=True, causal=causal, q_pos0=q_pos0)
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(wide).reshape(B, Sq, KVH, H // KVH, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(wide)) * hd ** -0.5
    s = torch.where(mask(Sq, Sk, causal, window, q.device, q_pos0), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(wide))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def check_tma_layout(name: str, x: torch.Tensor) -> None:
    """Raise `ValueError` unless the bfloat16 kernel's TMA loads can read
    `x` (B, S, heads, hd) in place: unit head-dim stride, the other strides
    (of dimensions longer than 1) multiples of 8 elements, a 16-byte
    aligned start and hd a multiple of 8."""
    hd = x.shape[3]
    if hd % 8:
        raise ValueError(f"the bfloat16 attention kernel takes a head size that is a "
                         f"multiple of 8; {name} has {hd}")
    if x.stride(3) != 1:
        raise ValueError(f"the bfloat16 attention kernel reads {name} through TMA, which "
                         f"needs unit head-dim stride; {name} has strides {x.stride()}")
    if any(x.stride(i) % 8 for i in range(3) if x.shape[i] > 1):
        raise ValueError(f"the bfloat16 attention kernel reads {name} through TMA, which "
                         f"needs strides that are multiples of 8 elements; {name} has "
                         f"strides {x.stride()}")
    if not _fake.is_fake(x) and x.data_ptr() % 16:
        raise ValueError(f"the bfloat16 attention kernel reads {name} through TMA, which "
                         f"needs 16-byte aligned data")


def kernel_attributes() -> dict:
    """Registers a thread (`numRegs`; the bfloat16 kernel's consumers raise
    theirs at run time with setmaxnreg), local (spill) bytes a thread and
    the largest block, of each template, by type and padded head size."""
    lib = _library()
    out = {}
    for dtype, hdps in TEMPLATES.items():
        for hdp in hdps:
            vals = (ctypes.c_int * 3)()
            err = lib.flash_attention_attributes(_DTYPES[getattr(torch, dtype)], hdp,
                                                 ctypes.cast(vals, ctypes.c_void_p))
            if err != 0:
                raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
            out[f"{dtype}/hd{hdp}"] = {"num_regs": vals[0], "local_bytes": vals[1],
                                       "max_threads": vals[2]}
    return out


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], q_pos0: int = 0) -> torch.Tensor:
    global launches
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or H > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"the attention kernel takes head_dim <= {MAX_HEAD_DIM} and at "
                         f"most {_MAX_GRID_YZ} heads and batch entries; got q "
                         f"{tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        if -(-Sq // _BF16_QUERIES_A_BLOCK) > _MAX_GRID_YZ:
            raise ValueError(f"the bfloat16 attention kernel takes at most "
                             f"{_MAX_GRID_YZ * _BF16_QUERIES_A_BLOCK} queries; got {Sq}")
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, x)
    if _fake.is_fake(q):
        return _fake.ops().flash_attention(q, k, v, causal, window or 0, q_pos0)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    fn = _library().flash_attention
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
             B, Sq, Sk, H, KVH, hd, int(causal), 0 if window is None else int(window),
             int(q_pos0), ctypes.cast(strides, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} "
                           f"(negative: the driver's error encoding a tensor map)")
    launches += 1
    return out


def backward_attributes() -> dict:
    """Registers a thread and local (spill) bytes a thread of the backward's
    two launches (``dq``, ``dkdv``), by type and padded head size, with the
    kernel each template is (`BWD_KERNELS`)."""
    fn = _build.bind("flash_attention_bwd", "flash_attention_bwd_attributes",
                     (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    out = {}
    for dtype, hdps in TEMPLATES.items():
        for hdp in hdps:
            for which, name in enumerate(("dq", "dkdv")):
                vals = (ctypes.c_int * 3)()
                err = fn(_DTYPES[getattr(torch, dtype)], hdp, which,
                         ctypes.cast(vals, ctypes.c_void_p))
                if err != 0:
                    raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
                out[f"{dtype}/hd{hdp}/{name}"] = {"kernel": BWD_KERNELS[dtype][which],
                                                  "num_regs": vals[0],
                                                  "local_bytes": vals[1]}
    return out


def _kernel_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                causal: bool, window: Optional[int], q_pos0: int = 0) -> tuple:
    """(dq, dk, dv) through the backward kernel, contiguous, of q's type."""
    global bwd_launches, bwd_cuda_launches
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    do = do.to(q.dtype)
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(name, x)
        do = do.contiguous()
    if _fake.is_fake(q):
        dq, dk, dv, *_ = _fake.ops().flash_attention_bwd(q, k, v, do, causal, window or 0,
                                                         q_pos0)
        return dq, dk, dv
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KVH, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    ws_floats = _build.bind("flash_attention_bwd", "flash_attention_bwd_workspace_floats",
                            (ctypes.c_int,) * 3, ctypes.c_longlong)(B, Sq, H)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    # bfloat16 with grouped heads: float32 partial sums of dv and dk over a KV
    # head's query heads (the tensor cores' accumulation loses a little on
    # every add, so each query head's walk is summed there)
    part_floats = _build.bind("flash_attention_bwd", "flash_attention_bwd_partial_floats",
                              (ctypes.c_int,) * 6, ctypes.c_longlong)(
        _DTYPES[q.dtype], B, Sk, H, KVH, hd)
    part = torch.empty(part_floats, dtype=torch.float32, device=q.device) if part_floats else None
    fn = _build.bind("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGS)
    strides = (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(), *do.stride())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    made = ctypes.c_int(0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
             None if part is None else part.data_ptr(), _DTYPES[q.dtype], B, Sq, Sk, H, KVH,
             hd, int(causal), 0 if window is None else int(window), int(q_pos0),
             ctypes.cast(strides, ctypes.c_void_p), stream, ctypes.byref(made))
    bwd_cuda_launches += made.value
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Kernel 5 forward and its backward kernel, for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], q_pos0: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_pos0 = causal, window, q_pos0
        return _kernel(q, k, v, causal, window, q_pos0)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _kernel_bwd(q, k, v, do, ctx.causal, ctx.window, ctx.q_pos0)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_pos0: int = 0) -> torch.Tensor:
    """Masked softmax attention, (B, Sq, H, hd) × (B, Sk, KVH, hd)² →
    (B, Sq, H, hd), the queries at positions ``q_pos0 ..``.  CUDA tensors go
    through `FlashAttention` (the forward kernel; its backward kernel when a
    gradient is taken), CPU tensors through `flash_attention_plain`, fake
    tensors of either device through `FlashAttention` to the kernels'
    fake-tensor routes (`_fake`)."""
    _check(q, k, v, window, causal=causal, q_pos0=q_pos0)
    if q.device.type == "cpu" and not _fake.is_fake(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_pos0=q_pos0)
    return FlashAttention.apply(q, k, v, causal, window, int(q_pos0))
