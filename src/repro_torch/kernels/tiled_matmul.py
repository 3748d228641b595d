"""Batched tiled matrix product with float32 accumulation: the CUDA kernel
and its plain version.

Port of `repro.kernels.tiled_matmul`.  `matmul(a, b)` computes ``C = A @ B``
for 2-D operands or with a leading batch axis on either or both (a 2-D
operand is broadcast over the other's batch), so one launch covers every
client of a stack.  Inputs may be float64, float32 or bfloat16; they are
converted to float32 as they are loaded and every sum accumulates in
float32, as the reference's kernel body does.  The result is float32, cast
to ``out_dtype`` at the end.

`matmul` launches the hand-written kernel (``csrc/tiled_matmul.cu``) on
CUDA tensors, reading each operand in place through its strides (a
transposed view or an expanded batch costs no copy), and takes the plain
PyTorch version, `matmul_plain`, only for tensors on the CPU.  The plain
version is ``a.float() @ b.float()``; on the card it is a full float32
product only with TF32 off, which `repro_torch.device.resolve` sets.

`plan` chooses the kernel's template from the operands' layout and shape,
openly and before the launch: the stream templates (a ring of 16-byte
asynchronous copies; tall 128-row tiles for M > 32, small 32-row tiles
otherwise) take operands whose contiguous axis has unit stride and whose
other strides and address are 16-byte aligned; every other layout takes
the general template.  Every block walks the whole of K for its tile and
writes it once, so a rerun gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._autograd import refuse_grad

#: launches of the CUDA kernel since the last reset, one a call (the plain
#: version on CPU tensors does not count)
launches = 0

#: dtype codes of the kernel's C interface
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: the kernel's grid puts the batch on its z axis
_MAX_BATCH = 65535
_INT_MAX = 2 ** 31 - 1

#: the kernel's templates, by their codes in the C interface
GENERAL, STREAM_TALL, STREAM_SMALL = 0, 1, 2
TEMPLATES = {GENERAL: "general", STREAM_TALL: "stream_tall", STREAM_SMALL: "stream_small"}
#: the C entry's prototype: a, its type and strides; b, its type and strides;
#: the output; batch, M, N, K, template, inner-k flags; the stream
_ARGS = ((ctypes.c_void_p, ctypes.c_int) + (ctypes.c_longlong,) * 3
         + (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_longlong,) * 3
         + (ctypes.c_void_p,) + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
#: output tile (rows, columns) of each template
TILES = {GENERAL: (64, 32), STREAM_TALL: (128, 32), STREAM_SMALL: (32, 32)}

class Plan(NamedTuple):
    """How one product is launched: the template, each operand's element
    strides as passed (batch, row, column; an axis of extent 1 takes
    whichever stride the template reads it with) and whether each operand's
    contiguous axis is K.  Every block walks the whole of K."""
    template: int
    a_strides: tuple
    b_strides: tuple
    a_inner_k: bool
    b_inner_k: bool

    @property
    def tile(self) -> tuple:
        return TILES[self.template]

    def grid(self, batch: int, M: int, N: int) -> tuple:
        """The launch grid (x, y, z) = (column tiles, row tiles, batch), as
        the C side computes it."""
        bm, bn = self.tile
        return (-(-N // bn), -(-M // bm), batch)

    def block(self, x: int, y: int, z: int, M: int, N: int, K: int) -> tuple:
        """The (batch entry, rows, columns, K range) block (x, y, z) of the
        grid computes, as the kernel derives it from its indices."""
        bm, bn = self.tile
        n0, m0 = x * bn, y * bm
        return z, range(m0, min(M, m0 + bm)), range(n0, min(N, n0 + bn)), range(0, K)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"matmul takes float32, float64 or bfloat16; {name} is {x.dtype}")
        if x.dim() not in (2, 3):
            raise ValueError(f"matmul takes 2-D or batched 3-D operands; {name} has "
                             f"shape {tuple(x.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dimensions differ: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"matmul operands lie on different devices {a.device}, {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul runs on cuda or cpu, got {a.device}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a.float() @ b.float()`` in PyTorch, cast to `out_dtype`."""
    _check(a, b)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def geometry(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The kernel's view of ``a @ b``: ``(batch, M, N, K, a_strides,
    b_strides)``, each operand's element strides as (batch, row, column),
    batch stride 0 for a 2-D operand broadcast over the other's batch."""
    batch = a.shape[0] if a.dim() == 3 else (b.shape[0] if b.dim() == 3 else 1)
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if batch > _MAX_BATCH or max(M, N, K) > _INT_MAX:
        raise ValueError(f"matmul kernel takes batch <= {_MAX_BATCH} and dimensions "
                         f"< 2**31; got a {tuple(a.shape)} @ b {tuple(b.shape)}")

    def strides(x):
        s = x.stride()
        return (s[0], s[1], s[2]) if x.dim() == 3 else (0, s[0], s[1])

    return batch, M, N, K, strides(a), strides(b)


def _stream_layout(strides: tuple, extents: tuple, itemsize: int, misalign: int):
    """Whether an operand (batch, rows, columns) of these extents can be
    streamed by 16-byte copies: returns ``(strides as passed, contiguous
    axis is the columns)`` or None.  The contiguous axis needs unit stride,
    the other strides a whole number of 16-byte chunks, the address 16-byte
    alignment; an axis of extent 1 takes stride 1 as the contiguous axis and
    0 otherwise."""
    if misalign % 16:
        return None
    v = 16 // itemsize
    for inner in (2, 1):                     # prefer the columns contiguous
        s = list(strides)
        for ax in (0, 1, 2):
            if extents[ax] == 1:
                s[ax] = 1 if ax == inner else 0
        if s[inner] == 1 and all(s[ax] % v == 0 for ax in (0, 1, 2) if ax != inner):
            return tuple(s), inner == 2
    return None


def plan(geom: tuple, a_itemsize: int, b_itemsize: int, a_misalign: int = 0,
         b_misalign: int = 0) -> Plan:
    """The launch of a product of `geometry` ``geom`` with operand element
    sizes in bytes and their addresses' residues mod 16: a stream template
    when both operands can be streamed (tall tiles for M > 32, small ones
    otherwise), else the general template."""
    batch, M, N, K, sa, sb = geom
    a = _stream_layout(sa, (batch, M, K), a_itemsize, a_misalign)
    # B's columns are N: its contiguous axis is K when it is the rows
    b = _stream_layout(sb, (batch, K, N), b_itemsize, b_misalign)
    if a is None or b is None:
        return Plan(GENERAL, sa, sb, sa[2] == 1, sb[1] == 1 and sb[2] != 1)
    template = STREAM_TALL if M > 32 else STREAM_SMALL
    return Plan(template, a[0], b[0], a[1], not b[1])


def _kernel(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    geom = geometry(a, b)
    batch, M, N, K = geom[:4]
    p = plan(geom, a.element_size(), b.element_size(), a.data_ptr() % 16, b.data_ptr() % 16)
    out = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    fn = _build.bind("tiled_matmul", "tiled_matmul", _ARGS)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), _DTYPES[a.dtype], *p.a_strides, b.data_ptr(), _DTYPES[b.dtype],
             *p.b_strides, out.data_ptr(), batch, M, N, K, p.template, int(p.a_inner_k),
             int(p.b_inner_k), stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul kernel launch failed ({TEMPLATES[p.template]} "
                           f"template): CUDA error {err}")
    launches += 1
    out = out if a.dim() == 3 or b.dim() == 3 else out[0]
    return out if out_dtype == torch.float32 else out.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``C = A @ B`` with float32 accumulation: (M, K) or (n, M, K) times
    (K, N) or (n, K, N), a 2-D operand broadcast over the other's batch.
    Launches the CUDA kernel on CUDA tensors (the template `plan` names);
    CPU tensors take `matmul_plain`."""
    _check(a, b)
    refuse_grad("tiled_matmul", a, b)
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype=out_dtype)
    return _kernel(a, b, out_dtype)

