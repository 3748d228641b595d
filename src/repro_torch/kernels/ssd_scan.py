"""Mamba2 SSD chunked scan with its final state: the CUDA kernel and its
plain version.

Port of `repro.kernels.ssd_scan` in the model's layout, the function of
`repro.models.layers._ssd_chunked`: for x (B, S, H, hd), dt (B, S, H),
A (H,) < 0 and B, C (B, S, N) shared by every head, all float32,

    y_t = Σ_{k ≤ t} exp(cs_t − cs_k) (C_t·B_k) dt_k x_k,   cs = cumsum(dt·A),

returned with the state after the last position, (B, H, hd, N), which the
decode cache carries on.

`ssd_scan` launches the hand-written kernel (``csrc/ssd_scan.cu``) on CUDA
tensors, reading its inputs in place through their strides, and takes the
plain PyTorch version, `ssd_scan_plain`, only for tensors on the CPU.  The
plain version transcribes `_ssd_chunked` with chunks of `chunk` positions
(shrunk to a divisor of S, as the reference's `ssd_scan` wrapper does); the
kernel walks chunks of `KERNEL_CHUNK` positions whatever `chunk` says.  The
chunk length changes only the rounding.

The kernel is chunk-parallel: one call makes four CUDA launches (the
chunks' decays and C·Bᵀ shared by the heads, the chunk states, the state
pass over the chunks in order, the outputs; counted in `cuda_launches`)
through a float32 workspace that the wrapper allocates at the size the
library gives (`ssd_scan_workspace_floats`), with every product on the
tensor cores as three TF32 products of split operands.  `ssd_scan_emulated`
is the kernel's arithmetic in PyTorch, at any chunk length, for accuracy
studies; no path runs it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: calls of the CUDA kernel since the last reset, one a call whatever its
#: CUDA launches (the plain version on CPU tensors does not count)
launches = 0
#: CUDA launches those calls made, as the library reports them
cuda_launches = 0

#: positions of the kernel's chunks, and the largest head size and state
#: size (each padded to a multiple of 32) it takes
KERNEL_CHUNK, MAX_PADDED = 128, 128
_MAX_BATCH = 65535
_NEG = -1e30


def _check(x, dt, A, B, C) -> None:
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan is float32-only; {name} is {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (batch, seq, heads, head_dim), got {tuple(x.shape)}")
    Bsz, S, H, _ = x.shape
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or B.dim() != 3 \
            or B.shape[:2] != (Bsz, S) or C.shape != B.shape:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    devices = {t.device for t in (x, dt, A, B, C)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan operands lie on different devices {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """`_ssd_chunked` in PyTorch: returns (y (B, S, H, hd), final state
    (B, H, hd, N))."""
    _check(x, dt, A, B, C)
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    c = max(1, min(chunk, S))
    while S % c:
        c -= 1
    n = S // c
    xh = x.reshape(Bsz, n, c, H, hd)
    dtc = dt.reshape(Bsz, n, c, H)
    Bc = B.reshape(Bsz, n, c, N)
    Cc = C.reshape(Bsz, n, c, N)

    cs = torch.cumsum(dtc * A, dim=2)                       # (B, n, c, H)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (B, n, q, k, H)
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    # mask before exp, as the reference does
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, _NEG))
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)
    M = CB[..., None] * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnqkh,bnkhd->bnqhd", M, xh)

    w = torch.exp(cs[:, :, -1:, :] - cs) * dtc              # (B, n, c, H)
    states = torch.einsum("bnkhd,bnks->bnhds", xh * w[..., None], Bc)
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (B, n, H)
    s = torch.zeros((Bsz, H, hd, N), dtype=x.dtype, device=x.device)
    s_in = []
    for i in range(n):
        s_in.append(s)
        s = s * chunk_decay[:, i, :, None, None] + states[:, i]
    s_in = torch.stack(s_in, dim=1)                         # (B, n, H, hd, N)
    y_inter = torch.einsum("bnqs,bnhds->bnqhd", Cc, s_in) * torch.exp(cs)[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, hd), s


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """`a` truncated to TF32 (its top 19 bits), as the kernel's split takes
    the high part and as the tensor core reads an operand."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """a @ b with float32 sums as the kernel's tensor cores take it: three
    TF32 products of split operands (a = hi + lo, lo = a − hi; "split"), or
    one of the truncated operands ("single"); "exact" is the full float32
    product (TF32 off), to separate the split's error from the rest.
    Products of TF32 values are exact in float32."""
    if products == "exact":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if products == "single":
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def ssd_scan_emulated(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, *, chunk: int = KERNEL_CHUNK,
                      products: str = "split") -> tuple:
    """What the chunk-parallel kernel computes, in PyTorch on any device:
    chunks of `chunk` positions (zero past S); per chunk the in-order
    float32 cumulative decay, its end at the last real position and C·Bᵀ
    once for the heads; per head the chunk state xᵀ·(w∘B), w = exp(cs_end −
    cs)·dt; the state pass s ← s·exp(cs_end) + state, in order; and y =
    exp(cs_q) C_q·s_in + M·x with M masked before its exponential; every
    product as `_product` takes it.  Returns (y, final state)."""
    _check(x, dt, A, B, C)
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    L = chunk
    nc = -(-S // L)
    dev = x.device

    def pad(t):
        return torch.cat([t, t.new_zeros((Bsz, nc * L - S) + t.shape[2:])], dim=1)

    xc = pad(x).reshape(Bsz, nc, L, H, hd)
    dtc = pad(dt).reshape(Bsz, nc, L, H)
    Bc, Cc = pad(B).reshape(Bsz, nc, L, N), pad(C).reshape(Bsz, nc, L, N)
    cs = torch.empty_like(dtc)
    run = torch.zeros((Bsz, nc, H), device=dev)
    for t in range(L):
        run = run + dtc[:, :, t] * A
        cs[:, :, t] = run
    last = torch.tensor([min(L, S - c * L) - 1 for c in range(nc)], device=dev)
    cs_end = cs[:, torch.arange(nc, device=dev), last]               # (B, nc, H)
    CB = _product(Cc, Bc.transpose(-1, -2), products)                # (B, nc, q, k)
    w = (torch.exp(cs_end[:, :, None] - cs) * dtc).permute(0, 1, 3, 2)
    wB = w[..., None] * Bc[:, :, None]                               # (B, nc, H, L, N)
    states = _product(xc.permute(0, 1, 3, 4, 2), wB, products)       # (B, nc, H, hd, N)
    s = torch.zeros((Bsz, H, hd, N), device=dev)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(cs_end[:, c])[:, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)
    y = _product(Cc[:, :, None], s_in.transpose(-1, -2), products)   # (B, nc, H, q, hd)
    y = y * torch.exp(cs).permute(0, 1, 3, 2)[..., None]
    causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()[None, None, :, :, None]
    seg = torch.where(causal, cs[:, :, :, None, :] - cs[:, :, None, :, :], _NEG)
    M = torch.where(causal, CB[..., None] * torch.exp(seg) * dtc[:, :, None], 0.0)
    y = y + _product(M.permute(0, 1, 4, 2, 3), xc.permute(0, 1, 3, 2, 4), products)
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * L, H, hd)[:, :S], s


def _kernel(x, dt, A, B, C) -> tuple:
    global launches, cuda_launches
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    if max(-(-hd // 32), -(-N // 32)) * 32 > MAX_PADDED or max(Bsz, H) > _MAX_BATCH:
        raise ValueError(
            f"the SSD kernel takes head_dim and d_state up to {MAX_PADDED} (batch and heads "
            f"up to {_MAX_BATCH}); got head_dim={hd}, d_state={N}, batch={Bsz}, heads={H}")
    lib = _build.load("ssd_scan")
    y = torch.empty((Bsz, S, H, hd), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
    ws_fn = lib.ssd_scan_workspace_floats
    ws_fn.argtypes = [ctypes.c_int] * 5
    ws_fn.restype = ctypes.c_longlong
    ws = torch.empty(ws_fn(Bsz, S, H, hd, N), dtype=torch.float32, device=x.device)
    A = A.contiguous()
    fn = lib.ssd_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(), *B.stride(), *C.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    made = ctypes.c_int(0)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
             y.data_ptr(), state.data_ptr(), ws.data_ptr(), Bsz, S, H, hd, N,
             ctypes.cast(strides, ctypes.c_void_p), stream, ctypes.byref(made))
    cuda_launches += made.value
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """The SSD over every position, (y (B, S, H, hd), final state
    (B, H, hd, N)).  Launches the CUDA kernel on CUDA tensors; CPU tensors
    take `ssd_scan_plain` with chunks of `chunk` positions.  `chunk` is the
    plain version's rounding choice only: the kernel walks its own
    `KERNEL_CHUNK`-position chunks whatever it says."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return _kernel(x, dt, A, B, C)
