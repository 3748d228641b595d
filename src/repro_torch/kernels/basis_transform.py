"""Two-sided basis transform (A·gᵢ)·B over a client stack: the CUDA kernel
and its plain version.

Port of `repro.kernels.basis_transform`.  The pytree bases of BL-DNN
(`repro_torch.core.basis.PerLayerSVDBasis` and the structured DCT /
Hadamard kinds) rotate every client's gradient leaf each round:
``Uᵀ · g · V`` for an (n, d1, d2) stack.  `basis_transform` launches the
hand-written kernel (``csrc/basis_transform.cu``) on CUDA tensors and takes
the plain PyTorch version, `basis_transform_plain`, only for tensors on
the CPU.  Both associate as (A·gᵢ)·B, in float32; the plain version with
TF32 off, the kernel as three TF32 tensor-core products of split operands
per product, which `basis_transform_emulated` repeats in PyTorch.

A may be contiguous or the transpose of a contiguous matrix (``U.mT``):
the kernel reads the latter in place.  `plan` chooses the kernel's form
and loader openly, before the launch: one fused launch whose blocks keep
their rows of A·gᵢ in shared memory (mma.sync; tiles by TMA, or by
cp.async where TMA cannot take an operand), or two launches of 128 × 128
tiles (wgmma, tiles by TMA) through a float32 workspace.  Both forms do
the same arithmetic and agree bitwise.  A form or loader the operands
cannot take raises; nothing falls back to another form or loader, or to
the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from ._autograd import refuse_grad

#: wrapper calls that launched the kernel since the last reset, one a call
#: (the plain version on CPU tensors does not count)
launches = 0
#: CUDA launches those calls made, as the C entry reports them (1 a call in
#: the fused form, 2 in the two-stage form)
cuda_launches = 0

FUSED, TWO_STAGE = "fused", "two_stage"
_FORM_CODES = {FUSED: 0, TWO_STAGE: 1}
#: how a form brings its tiles into shared memory
TMA, CP_ASYNC = "tma", "cp_async"
#: the C entry's answer for a form these shapes cannot take
_REFUSED = -1
#: rows of A a block owns in each form; the fused form's columns a pass
BM = {FUSED: 16, TWO_STAGE: 128}
FUSED_BN = 32
#: K depth of a staged tile and of one summation partial; the fused form's
#: ring depth (every BL-DNN leaf's steps in flight at once)
K_TILE, FUSED_STAGES = 32, 6
#: the mma's depth: a K-tile is summed in steps of this many terms
MMA_K = 8
#: the fused form's widest operand: its blocks own 16 rows and a warp one
#: 16 × 8 tile, built for latency at the path's widths (≤ 96); past this
#: the two-stage form's 128 × 128 tiles re-read gᵢ and B from L2 8× less
#: often than the fused form's da/16 row blocks
FUSED_MAX_WIDTH = 256
#: the most dynamic shared memory one block may use on an H100
_SMEM_MAX = 227 * 1024
#: the grid axis that carries the clients
_MAX_CLIENTS = 65535

_ARGS = ((ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
         + (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)))


def fused_smem_bytes(d2: int) -> int:
    """Shared memory of one fused block: the ring of `FUSED_STAGES` (A tile,
    gᵢ or B tile) stages, the (16, ceil(d2/32)·32 + 8) stripe of A·gᵢ, a
    barrier a stage and 1024 bytes to align the ring for TMA, as the C
    entry computes it (``fused_smem_bytes``)."""
    bm = BM[FUSED]
    stage = max(bm * (K_TILE + 8), K_TILE * (bm + 4)) + K_TILE * (FUSED_BN + 4)
    stripe = bm * (-(-d2 // FUSED_BN) * FUSED_BN + 8)
    return 1024 + 4 * (FUSED_STAGES * stage + stripe) + 8 * FUSED_STAGES


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one (n; da × d1 · d1 × d2 · d2 × db) call."""
    n: int
    da: int
    d1: int
    d2: int
    db: int
    #: `FUSED` (one launch, A·gᵢ kept in shared memory) or `TWO_STAGE` (A·gᵢ
    #: through a workspace in device memory)
    form: str
    #: rows of A a block owns
    bm: int
    #: `TMA` or `CP_ASYNC` (the fused form only: widths TMA cannot take, or
    #: an operand not 16-byte aligned)
    loader: str
    #: A is read from the storage of its transpose (``U.mT``)
    a_trans: bool = False

    @property
    def launches(self) -> int:
        """CUDA launches a call makes."""
        return 1 if self.form == FUSED else 2

    @property
    def workspace_floats(self) -> int:
        """Floats of the two-stage form's workspace, (n, da, d2 rounded up to
        a multiple of 4); 0 for the fused form."""
        return self.n * self.da * (-(-self.d2 // 4) * 4) if self.form == TWO_STAGE else 0

    def row_blocks(self) -> list:
        """The [start, stop) rows of A each block row owns (the same for every
        client; the two-stage form's second launch tiles its rows alike)."""
        return [(r, min(self.da, r + self.bm)) for r in range(0, self.da, self.bm)]


@functools.lru_cache(maxsize=None)
def plan(n: int, da: int, d1: int, d2: int, db: int, a_trans: bool = False,
         aligned: bool = True) -> Plan:
    """The kernel's form and loader for these shapes (A given transposed
    when `a_trans`; `aligned`: A, gᵢ and B all start on 16 bytes).  TMA
    takes operands that start on 16 bytes and rows of a whole number of 16
    bytes (A's, gᵢ's and B's widths multiples of 4 floats).  Fused where a
    block's stripe of A·gᵢ fits its shared memory and no width passes
    `FUSED_MAX_WIDTH`, which covers every BL-DNN leaf, by TMA where it can
    take the operands and by cp.async where it cannot; two-stage (TMA)
    otherwise.  Wide shapes TMA cannot take stay fused."""
    fits = fused_smem_bytes(d2) <= _SMEM_MAX
    tma = aligned and (da if a_trans else d1) % 4 == 0 and d2 % 4 == 0 and db % 4 == 0
    fused = fits and (max(d1, d2, db) <= FUSED_MAX_WIDTH or not tma)
    form = FUSED if fused else TWO_STAGE
    return Plan(n=n, da=da, d1=d1, d2=d2, db=db, form=form, bm=BM[form],
                loader=TMA if tma else CP_ASYNC, a_trans=a_trans)


def _transposed(A: torch.Tensor) -> bool:
    """Whether the kernel reads A from its transpose's storage: A is not
    contiguous but A.mT is (``U.mT`` of a contiguous U)."""
    return not A.is_contiguous() and A.mT.is_contiguous()


def _aligned(*xs: torch.Tensor) -> bool:
    """Whether every tensor's data starts on 16 bytes, as TMA needs."""
    return all(x.data_ptr() % 16 == 0 for x in xs)


def _check(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> bool:
    """Raises for operands no version takes; else returns whether A is read
    from its transpose's storage (`_transposed`)."""
    if g.dim() != 3:
        raise ValueError(
            f"basis_transform takes a client-stacked (n, d1, d2) leaf, got "
            f"shape {tuple(g.shape)}")
    for name, x in (("A", A), ("g", g), ("B", B)):
        if x.dtype != torch.float32:
            raise TypeError(f"basis_transform is float32-only, {name} is {x.dtype}")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != g.shape[1] \
            or B.shape[0] != g.shape[2]:
        raise ValueError(
            f"factor/leaf shape mismatch: A {tuple(A.shape)} · g {tuple(g.shape)} "
            f"· B {tuple(B.shape)}")
    for name, x in (("g", g), ("B", B)):
        if not x.is_contiguous():
            raise ValueError(f"basis_transform needs contiguous tensors, {name} is not")
    a_trans = _transposed(A)
    if not (a_trans or A.is_contiguous()):
        raise ValueError("basis_transform needs A contiguous or the transpose of a "
                         "contiguous matrix")
    devices = {A.device, g.device, B.device}
    if len(devices) != 1:
        raise ValueError(f"basis_transform operands lie on different devices {devices}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"basis_transform runs on cuda or cpu, got {g.device}")
    return a_trans


def basis_transform_plain(A: torch.Tensor, g: torch.Tensor,
                          B: torch.Tensor) -> torch.Tensor:
    """``(A @ g[i]) @ B`` for every client i in PyTorch: (da, d1) ×
    (n, d1, d2) × (d2, db) → (n, da, db)."""
    _check(A, g, B)
    return torch.matmul(torch.matmul(A, g), B)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32 (its top 19 bits), nearest with ties away from
    zero, as the kernel's split rounds each part."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulated_product(X: torch.Tensor, Y: torch.Tensor, products: str,
                      k_tile: int) -> torch.Tensor:
    """X @ Y as the kernel sums it: each `k_tile`-deep slice of K into fresh
    float32 partials, in steps of `MMA_K` terms, added to the running sum in
    order.  "split": each step adds lo·hi and hi·lo of the split operands
    to a small partial and hi·hi to a big one, and the slice adds big +
    small; "single": one TF32 product of the rounded operands a step;
    "exact": the float32 product."""
    if products not in ("split", "single", "exact"):
        raise ValueError(f"products is split, single or exact, not {products!r}")
    K = X.shape[-1]
    if products == "exact":
        small, big = [], (X, Y)
    else:
        Xh, Yh = _tf32(X), _tf32(Y)
        big = (Xh, Yh)
        small = [(_tf32(X - Xh), Yh), (Xh, _tf32(Y - Yh))] if products == "split" else []

    def term(x, y, k):
        return x[..., k:k + MMA_K] @ y[..., k:k + MMA_K, :]

    acc = None
    for k0 in range(0, K, k_tile):
        s_part = b_part = None
        for k in range(k0, min(K, k0 + k_tile), MMA_K):
            for x, y in small:
                s_part = term(x, y, k) if s_part is None else s_part + term(x, y, k)
            b_part = term(*big, k) if b_part is None else b_part + term(*big, k)
        part = b_part if s_part is None else b_part + s_part
        acc = part if acc is None else acc + part
    return acc


def basis_transform_emulated(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor, *,
                             products: str = "split",
                             k_tile: int = K_TILE) -> torch.Tensor:
    """What the kernel computes, in PyTorch on any device: T = A·gᵢ rounded
    to float32, then T·B, each product as `_emulated_product` takes it.
    Within a step the tensor core adds its eight products in an order of its
    own, so the kernel and the emulation may differ in the last bits."""
    _check(A, g, B)
    return _emulated_product(_emulated_product(A, g, products, k_tile), B, products, k_tile)


def _kernel(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor, p: Plan) -> torch.Tensor:
    global launches, cuda_launches
    fn = _build.bind("basis_transform", "basis_transform_f32", _ARGS)
    n, d1, d2 = g.shape
    da, db = A.shape[0], B.shape[1]
    if (p.n, p.da, p.d1, p.d2, p.db, p.a_trans) != (n, da, d1, d2, db, not A.is_contiguous()):
        raise ValueError(f"plan for {(p.n, p.da, p.d1, p.d2, p.db)}, A transposed: {p.a_trans}, "
                         f"given {(n, da, d1, d2, db)}, A contiguous: {A.is_contiguous()}")
    out = torch.empty((n, da, db), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    if d1 == 0 or d2 == 0:
        return out.zero_()
    ws = (torch.empty(p.workspace_floats, dtype=torch.float32, device=g.device)
          if p.form == TWO_STAGE else None)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    made = ctypes.c_int(0)
    err = fn(A.data_ptr(), int(p.a_trans), g.data_ptr(), B.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), n, da, d1, d2, db, _FORM_CODES[p.form],
             int(p.loader == TMA), stream, ctypes.byref(made))
    cuda_launches += made.value
    if err == _REFUSED:
        raise ValueError(
            f"basis_transform's {p.form} form by {p.loader} cannot take {(n, da, d1, d2, db)}: "
            f"the fused form keeps a block's 16 rows of A·gᵢ in shared memory "
            f"({fused_smem_bytes(d2)} bytes at d2={d2}, of {_SMEM_MAX}); TMA (the two-stage "
            f"form's only loader) needs widths of whole 16 bytes and 16-byte aligned "
            f"operands; either form takes at most {_MAX_CLIENTS} clients")
    if err != 0:
        raise RuntimeError(f"basis_transform {p.form} launch failed: CUDA error {err}")
    launches += 1
    return out


def basis_transform(A: torch.Tensor, g: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(A @ g[i]) @ B`` for every client i: (da, d1) × (n, d1, d2) ×
    (d2, db) → (n, da, db), float32.  Launches the CUDA kernel on CUDA
    tensors in `plan`'s form and loader (raising `ValueError` for shapes
    it cannot take); CPU tensors take `basis_transform_plain`."""
    a_trans = _check(A, g, B)
    refuse_grad("basis_transform", A, g, B)
    if g.device.type == "cpu":
        return basis_transform_plain(A, g, B)
    n, d1, d2 = g.shape
    return _kernel(A, g, B, plan(n, A.shape[0], d1, d2, B.shape[1], a_trans, _aligned(A, g, B)))
